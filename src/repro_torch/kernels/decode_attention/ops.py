"""Public op: single-token GQA decode attention.

``q (B, H, dh)``, ``k/v (B, S, KV, dh)``, ``lengths (B,)`` -> ``(B, H, dh)``,
the JAX package's layout.  CPU tensors go to the plain version (``ref.py``);
CUDA tensors launch the Hopper kernel ``csrc/decode_attention.cu`` or raise.
G = H // KV is taken as it is (no padding) and S may be any length.
``decode_attention.launches`` counts kernel launches and
``decode_attention.plain_calls`` counts plain-version calls.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.decode_attention.ref import decode_attention_ref

MAX_DH = 256
TILE = 32           # cache rows per tile in the kernel (its shared-memory layout)
SMEM_MAX = 232_448  # bytes of shared memory a Hopper block can use
_DTYPES = (torch.float32, torch.bfloat16)


def _lib():
    lib = _build.load("decode_attention")
    fn = lib.decode_attention_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _check(q, k_cache, v_cache, lengths):
    if q.dim() != 3 or k_cache.dim() != 4 or v_cache.shape != k_cache.shape:
        raise ValueError("q must be (B, H, dh) and k/v (B, S, KV, dh) of one shape")
    B, H, dh = q.shape
    Bk, S, KV, dhk = k_cache.shape
    if Bk != B or dhk != dh or H % KV:
        raise ValueError(f"q {tuple(q.shape)} does not match cache {tuple(k_cache.shape)}")
    if q.dtype not in _DTYPES or k_cache.dtype != q.dtype or v_cache.dtype != q.dtype:
        raise TypeError("q, k and v must share one dtype, float32 or bfloat16")
    if lengths.shape != (B,) or lengths.dtype != torch.int32:
        raise ValueError("lengths must be (B,) int32")
    devs = {t.device for t in (q, k_cache, v_cache, lengths)}
    if len(devs) != 1:
        raise ValueError(f"inputs lie on several devices: {sorted(map(str, devs))}")
    return B, H, dh, S, KV


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """One-token attention of q against the first ``lengths[b]`` cache rows.

    ``lengths`` must be >= 1 (on the serving path an empty slot decodes with
    ``cache_len + 1 = 1``); the kernel returns zeros for a length of 0.
    """
    B, H, dh, S, KV = _check(q, k_cache, v_cache, lengths)
    dev = q.device
    if dev.type == "cpu":
        decode_attention.plain_calls += 1
        return decode_attention_ref(q, k_cache, v_cache, lengths)
    if dev.type != "cuda":
        raise ValueError(f"decode_attention runs on cpu or cuda tensors, not {dev.type}")
    esize = q.element_size()
    if dh > MAX_DH or (dh * esize) % 16:
        raise ValueError(f"the CUDA decode_attention needs dh <= {MAX_DH} and "
                         f"dh * {esize} bytes a multiple of 16, got dh={dh}")
    G = H // KV
    smem = esize * 4 * TILE * dh + 4 * (2 * G * dh + G * TILE + 3 * G)
    if smem > SMEM_MAX:
        raise ValueError(f"G={G}, dh={dh} need {smem} bytes of shared memory, over {SMEM_MAX}")
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache),
                    ("lengths", lengths)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    out = torch.empty_like(q)
    if B == 0:
        return out
    rc = _lib()(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), lengths.data_ptr(),
        out.data_ptr(), B, S, KV, G, dh, int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "decode_attention")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
decode_attention.plain_calls = 0
