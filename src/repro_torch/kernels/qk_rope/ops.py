"""Public op: per-head qk-norm + split-half RoPE of q and k, and the decode
step's K/V cache write, in one launch.

``qk_rope(q, k, positions, theta=, q_scale=, k_scale=, eps=, v=, k_cache=,
v_cache=, slot=)`` -> (q, k), q (B, S, H, dh) and k (B, S, KV, dh) in the
JAX package's layout; ``theta=None`` skips RoPE, ``q_scale=None`` the
qk-norm; with caches (B, rows, KV, dh), decode (S = 1) writes k (after the
norm and RoPE) and v at row ``clamp(slot[b], 0, rows - 1)`` in place.
Without the norm and RoPE only the caches are written and q and k come
back as they were given.  CPU tensors go to the plain version
(``ref.py``); CUDA tensors launch the Hopper kernel ``csrc/qk_rope.cu`` or
raise (under the private ``kernels._plain.plain_on_card()`` they too take
the plain version).  ``qk_rope.launches`` counts kernel launches and
``qk_rope.plain_calls`` plain-version calls.

The RoPE frequency table is built once per (dh, theta, device) by the
plain version's own ``rope_frequencies`` on that device, so the kernel
rotates by the same f32 table as the plain chain.  A CUDA graph cannot
build it: the first call for a (dh, theta, device) must run outside a
capture (the engine's warm-up run is one).  The kernel has no backward:
the model calls this op only in its serving modes, and a call that needs a
gradient raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, _plain
from repro_torch.kernels.qk_rope.ref import qk_rope_ref, rope_frequencies

_DTYPES = (torch.float32, torch.bfloat16)
_tables: dict[tuple[int, float, torch.device], torch.Tensor] = {}
_lib = None  # (qk_rope_launch, qk_rope_max_dh()), bound once


def _launcher():
    global _lib
    if _lib is None:
        lib = _build.load("qk_rope")
        fn = lib.qk_rope_launch
        fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong]
                       + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_float]
                       + [ctypes.c_int] * 3 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.qk_rope_max_dh.restype = ctypes.c_int
        _lib = (fn, lib.qk_rope_max_dh())
    return _lib


def frequency_table(d: int, theta: float, device: torch.device) -> torch.Tensor:
    """The (d/2,) f32 RoPE table of (d, theta) on ``device``, built once."""
    key = (d, float(theta), device)
    t = _tables.get(key)
    if t is None:
        if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
            raise RuntimeError(f"the RoPE table of dh {d}, theta {theta} is not built yet; "
                               "a CUDA graph cannot build it: call qk_rope once before capturing")
        t = _tables[key] = rope_frequencies(d, theta, device)
    return t


def _check(q, k, positions, theta, q_scale, k_scale, v, k_cache, v_cache, slot):
    if q.dim() != 4 or k.dim() != 4 or q.shape[:2] != k.shape[:2] or q.shape[3] != k.shape[3]:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} must be (B, S, heads, dh)")
    if q.dtype != k.dtype:
        raise TypeError("q and k must share one dtype")
    B, S, H, dh = q.shape
    if dh % 2:
        raise ValueError(f"RoPE's split halves need an even dh, got {dh}")
    if (q_scale is None) != (k_scale is None):
        raise ValueError("the qk-norm takes both q_scale and k_scale or neither")
    if q_scale is not None and (q_scale.shape != (dh,) or k_scale.shape != (dh,)):
        raise ValueError(f"the qk-norm scales must be ({dh},)")
    if theta is not None and (positions is None or positions.shape != (B, S)):
        raise ValueError(f"RoPE needs positions of shape ({B}, {S})")
    if (k_cache is None) != (v_cache is None) or (k_cache is None) != (slot is None) or (
            (k_cache is None) != (v is None)):
        raise ValueError("the cache write takes v, k_cache, v_cache and slot together")
    if k_cache is not None:
        if S != 1 or v.shape != k.shape or k_cache.shape != v_cache.shape or (
                k_cache.dim() != 4 or k_cache.shape[0] != B or k_cache.shape[2:] != k.shape[2:]):
            raise ValueError(f"caches {tuple(k_cache.shape)} / v {tuple(v.shape)} do not "
                             f"match k {tuple(k.shape)} (decode writes one row, S = 1)")
        if k_cache.dtype != k.dtype or v_cache.dtype != k.dtype or v.dtype != k.dtype:
            raise TypeError("the caches and v must be of k's dtype")
        if slot.shape != (B,):
            raise ValueError(f"slot must be ({B},)")
    devs = {t.device for t in (q, k, positions, q_scale, k_scale, v, k_cache, v_cache, slot)
            if t is not None}
    if len(devs) != 1:
        raise ValueError(f"inputs lie on several devices: {sorted(map(str, devs))}")


def qk_rope(q: torch.Tensor, k: torch.Tensor, positions=None, *, theta=None, q_scale=None,
            k_scale=None, eps: float = 1e-6, v=None, k_cache=None, v_cache=None, slot=None):
    args = (q, k, positions, theta, q_scale, k_scale, v, k_cache, v_cache, slot)
    _check(*args)
    if q.device.type == "cuda" and not _plain.active():
        return _launch(*args, eps)
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"qk_rope runs on cpu or cuda tensors, not {q.device.type}")
    qk_rope.plain_calls += 1
    return qk_rope_ref(q, k, positions, theta=theta, q_scale=q_scale, k_scale=k_scale, eps=eps,
                       v=v, k_cache=k_cache, v_cache=v_cache, slot=slot)


def _launch(q, k, positions, theta, q_scale, k_scale, v, k_cache, v_cache, slot, eps):
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in (q, k, q_scale, k_scale, v)):
        raise RuntimeError("the CUDA qk_rope has no backward: call the plain chain under autograd")
    if q.dtype not in _DTYPES or (q_scale is not None and (
            q_scale.dtype not in _DTYPES or k_scale.dtype != q_scale.dtype)):
        raise TypeError("qk_rope takes f32 or bf16 activations and scales")
    B, S, H, dh = q.shape
    KV = k.shape[2]
    launch, max_dh = _launcher()
    if dh > max_dh:
        raise ValueError(f"the CUDA qk_rope needs dh <= {max_dh}, got {dh}")
    tensors = (("q", q), ("k", k), ("v", v), ("q_scale", q_scale), ("k_scale", k_scale),
               ("k_cache", k_cache), ("v_cache", v_cache), ("slot", slot))
    for name, t in tensors:
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    # 16-byte accesses where every head's halves are whole vectors
    vec = (dh // 2) % (16 // q.element_size()) == 0 and all(
        t is None or t.data_ptr() % 16 == 0 for _, t in tensors[:7])
    if slot is not None and slot.dtype != torch.int32:
        raise TypeError("slot must be int32")
    transform = theta is not None or q_scale is not None
    freqs = frequency_table(dh, theta, q.device) if theta is not None else None
    pos64 = psb = pss = 0
    if theta is not None:
        if positions.dtype not in (torch.int32, torch.int64):
            raise TypeError("positions must be int32 or int64")
        pos64, (psb, pss) = int(positions.dtype == torch.int64), positions.stride()
    q_out = torch.empty_like(q) if transform else q
    k_out = torch.empty_like(k) if transform else k
    if B * S:
        ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
        rc = launch(
            q.data_ptr(), k.data_ptr(), ptr(v), ptr(q_out) if transform else None,
            ptr(k_out) if transform else None, ptr(q_scale), ptr(k_scale), ptr(freqs),
            ptr(positions) if theta is not None else None, pos64, psb, pss, ptr(k_cache),
            ptr(v_cache), ptr(slot), 0 if k_cache is None else k_cache.shape[1], B, S, H, KV, dh,
            eps, int(q.dtype == torch.bfloat16),
            int(q_scale is not None and q_scale.dtype == torch.bfloat16), int(vec),
            torch.cuda.current_stream(q.device).cuda_stream)
        _build.check(rc, "qk_rope")
        qk_rope.launches += 1
    return q_out, k_out


qk_rope.launches = 0
qk_rope.plain_calls = 0
