"""Checkpoint and restore of a train state (the JAX package's
``training/checkpoint.py``, with the same layout).

Format: <dir>/step_<N>/
    manifest.json   — the step, extra metadata, and for each leaf its key
                      path, shard, name, shape and dtype
    shard_<i>.npz   — array payloads (chunked ~512 MB per file)

The JAX package writes its manifest with msgpack; the port writes JSON and
needs neither msgpack nor ml_dtypes: a bf16 leaf is stored as its uint16
bits under the dtype ``"bfloat16"``.  Writes are atomic (tmp dir + rename),
so a crash mid-save never corrupts the latest checkpoint; ``latest_step``
scans completed saves only.  Restore places every leaf on one device.
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.training.tree import leaves_with_paths, unflatten

_CHUNK_BYTES = 512 << 20
_MANIFEST = "manifest.json"


def _to_numpy(t: torch.Tensor) -> tuple[np.ndarray, str]:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    arr = t.numpy()
    return arr, str(arr.dtype)


def _to_tensor(arr: np.ndarray, dtype: str, device) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


def save_checkpoint(ckpt_dir: str, step: int, tree: Any,
                    extra: Optional[dict] = None, keep: int = 3) -> str:
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    os.makedirs(tmp, exist_ok=True)

    manifest = {"step": step, "extra": extra or {}, "leaves": []}
    shard_idx, shard_bytes, shard_payload = 0, 0, {}

    def flush():
        nonlocal shard_idx, shard_bytes, shard_payload
        if shard_payload:
            np.savez(os.path.join(tmp, f"shard_{shard_idx}.npz"), **shard_payload)
            shard_idx += 1
            shard_bytes, shard_payload = 0, {}

    for i, (k, leaf) in enumerate(leaves_with_paths(tree)):
        arr, dtype = _to_numpy(leaf)
        name = f"a{i}"
        manifest["leaves"].append(
            {"key": k, "shard": shard_idx, "name": name,
             "shape": list(arr.shape), "dtype": dtype}
        )
        shard_payload[name] = arr
        shard_bytes += arr.nbytes
        if shard_bytes >= _CHUNK_BYTES:
            flush()
    flush()
    with open(os.path.join(tmp, _MANIFEST), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    _prune(ckpt_dir, keep)
    return final


def _prune(ckpt_dir: str, keep: int) -> None:
    steps = sorted(latest_steps(ckpt_dir))
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"), ignore_errors=True)


def latest_steps(ckpt_dir: str) -> list[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for d in os.listdir(ckpt_dir):
        if d.startswith("step_") and not d.endswith(".tmp"):
            if os.path.exists(os.path.join(ckpt_dir, d, _MANIFEST)):
                out.append(int(d.split("_")[1]))
    return sorted(out)


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = latest_steps(ckpt_dir)
    return steps[-1] if steps else None


def restore_checkpoint(ckpt_dir: str, step: Optional[int] = None,
                       like: Any = None, device="cuda"):
    """Returns (step, tree, extra), every leaf a tensor on ``device``.
    ``like`` (a tree of tensors, e.g. on the meta device) gives the tree's
    structure, and each restored leaf must have its shape and dtype; without
    it a dict keyed by leaf path is returned."""
    dev = resolve_device(device)
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, _MANIFEST)) as f:
        manifest = json.load(f)
    shards: dict[int, Any] = {}

    def load(entry):
        si = entry["shard"]
        if si not in shards:
            shards[si] = np.load(os.path.join(d, f"shard_{si}.npz"))
        return _to_tensor(shards[si][entry["name"]], entry["dtype"], dev)

    by_key = {e["key"]: load(e) for e in manifest["leaves"]}
    if like is None:
        return step, by_key, manifest["extra"]
    vals = []
    for k, leaf in leaves_with_paths(like):
        v = by_key[k]
        if v.shape != leaf.shape or v.dtype != leaf.dtype:
            raise ValueError(f"checkpoint leaf {k}: {tuple(v.shape)} {v.dtype}, expected "
                             f"{tuple(leaf.shape)} {leaf.dtype}")
        vals.append(v)
    return step, unflatten(like, vals), manifest["extra"]
