"""Parameter trees: nested dicts and lists of tensors (the JAX pytrees of
the port).  Leaves are visited in JAX's flatten order (dict keys sorted,
lists in order), so a reduction over them (``optimizer.global_norm``) adds
in the JAX order and a checkpoint's leaf keys are the JAX key paths."""
from __future__ import annotations


def leaves_with_paths(tree, prefix: str = "") -> list:
    """[(path, leaf)] in flatten order; a path joins keys and list indices
    with '/' (``params/segments/0/mixer/wq``), as the JAX checkpoint does."""
    if isinstance(tree, dict):
        return [kv for key in sorted(tree)
                for kv in leaves_with_paths(tree[key], f"{prefix}/{key}" if prefix else str(key))]
    if isinstance(tree, (list, tuple)):
        return [kv for i, val in enumerate(tree)
                for kv in leaves_with_paths(val, f"{prefix}/{i}" if prefix else str(i))]
    return [(prefix, tree)]


def leaves(tree) -> list:
    return [leaf for _, leaf in leaves_with_paths(tree)]


def unflatten(like, values):
    """A tree shaped as ``like`` whose leaves, in flatten order, are
    ``values``."""
    it = iter(values)

    def build(node):
        if isinstance(node, dict):
            return {key: build(node[key]) for key in sorted(node)}
        if isinstance(node, (list, tuple)):
            return [build(val) for val in node]
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more values than the tree has leaves")
    return out


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure)."""
    if isinstance(tree, dict):
        return {key: tree_map(fn, val, *(r[key] for r in rest)) for key, val in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, val, *(r[i] for r in rest)) for i, val in enumerate(tree)]
    return fn(tree, *rest)
