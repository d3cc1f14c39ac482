"""The model's weights, made by the benchmark from ``--seed`` on the device.

The program's parameter tree (``lm.init_params(cfg, device="meta")`` gives
its leaves' names, shapes and dtypes, and draws nothing) is filled from one
``torch.Generator`` on the card: one flat buffer per dtype, one
``normal_`` call each, every leaf a view into it, then one in-place scale a
leaf.  Matrices are normal / sqrt(fan_in) (their second-to-last dim), the
embedding normal * 0.02, norm scales 1 + 0.1 * normal, biases 0; a leaf
that is none of these and no matrix takes the rule its family module names
for it (``families/<model_type>.py``'s ``WEIGHTS``), or is refused.  The
same tensors go to the program and to the reference, which reads them by
name and derives nothing from the program.
"""
from __future__ import annotations

import math

NORM_KEYS = ("scale", "q_norm", "k_norm", "kv_norm")
RULES = ("norm", "zero", "small")
CHUNK = 1 << 30


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


def _set(tree, path, value):
    for p in path[:-1]:
        tree = tree[p]
    tree[path[-1]] = value


def _rule(path, shape, rules: dict) -> str:
    """How leaf ``path`` of ``shape`` is scaled: "norm", "zero", "small" or
    "matrix".  Leaves under ``segments`` are stacked over their layers, so a
    layer's leaf has one dim fewer."""
    name = path[-1]
    if name in NORM_KEYS:
        return "norm"
    if name.startswith("b") and len(name) <= 2:
        return "zero"  # biases (bq, bk, bv, b1, b2)
    if name == "embed":
        return "small"
    if name in rules:
        if rules[name] not in RULES:
            raise ValueError(f"leaf {path}: rule {rules[name]!r} is none of {RULES}")
        return rules[name]
    if len(shape) - (path[0] == "segments") < 2:
        raise ValueError(f"leaf {path} of shape {tuple(shape)} is no matrix, norm or bias, "
                         "and its family module names no rule for it")
    return "matrix"


def make_params(torch, meta_tree, seed: int, device, rules: dict | None = None):
    """The program's parameter tree, filled from ``seed`` on ``device``;
    ``rules``: {leaf name: "norm" | "zero" | "small"} for the family's leaves
    that the rules above do not cover."""
    leaves = list(_leaves(meta_tree))
    rule_of = {path: _rule(path, t.shape, rules or {}) for path, t in leaves}  # before any draw
    by_dtype: dict = {}
    for path, t in leaves:
        by_dtype.setdefault(t.dtype, []).append((path, t))
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) & ((1 << 63) - 1))
    out = _copy_structure(meta_tree)
    for dtype in sorted(by_dtype, key=str):
        group = by_dtype[dtype]
        total = sum(t.numel() for _, t in group)
        flat = torch.empty((total,), dtype=dtype, device=device)
        for lo in range(0, total, CHUNK):  # a few large calls, each under 2**31 elements
            flat[lo: lo + CHUNK].normal_(generator=gen)
        at = 0
        for path, t in group:
            leaf = flat[at: at + t.numel()].view(t.shape)
            at += t.numel()
            rule = rule_of[path]
            if rule == "norm":
                leaf.mul_(0.1).add_(1.0)
            elif rule == "zero":
                leaf.zero_()
            elif rule == "small":
                leaf.mul_(0.02)
            else:
                leaf.mul_(1.0 / math.sqrt(t.shape[-2]))
            _set(out, path, leaf)
    return out


def _copy_structure(tree):
    if isinstance(tree, dict):
        return {k: _copy_structure(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_copy_structure(v) for v in tree]
    return None
