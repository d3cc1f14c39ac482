"""Public op: single-token GQA decode attention.

``q (B, H, dh)``, ``k/v (B, S, KV, dh)``, ``lengths (B,)`` -> ``(B, H, dh)``,
the JAX package's layout.  CPU tensors go to the plain version (``ref.py``);
CUDA tensors launch the Hopper kernel ``csrc/decode_attention.cu`` or raise.
G = H // KV is taken as it is (no padding) and S may be any length.  The
kernel splits the cache into chunks, one block each (see the source note);
the chunk is chosen here from S and the grid size, never from the lengths,
which lie on the card.  ``decode_attention.launches`` counts kernel
launches (one a call) and
``decode_attention.plain_calls`` counts plain-version calls.

The function is also the custom operator ``repro_torch::decode_attention``
(``torch.library``), whose CPU and CUDA implementations are the plain
version and the kernel, and whose fake implementation gives only the
output shapes: the dry-run traces it on fake tensors, which reach neither.
Plain tensors skip the dispatcher and call the implementation directly
(the decode step makes one call a layer).  A DTensor has no sharding rule
for it and raises: the sharded decode (``models.layers``) calls it on each
rank's local block.  With
``return_lse`` the kernel also writes each head's log-sum-exp of its scores,
which combines the partial outputs of a sequence-sharded cache.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.decode_attention.ref import decode_attention_ref

MAX_DH = 256
WAVES = 8        # blocks over the whole cache per SM the chunk is sized for
CHUNK_MIN = 64   # fewest cache rows a block takes, unless forced
CHUNK_ALIGN = 32
_DTYPES = (torch.float32, torch.bfloat16)


def _lib():
    lib = _build.load("decode_attention")
    fn = lib.decode_attention_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
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


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _split_plan(B: int, KV: int, G: int, S: int, n_sm: int, chunk: int | None = None):
    """(heads a block, head groups, cache rows a block, splits) for the kernel.

    A block takes GB = 1, 2, 4 or 8 query heads of one kv head; the cache is
    cut into chunks so that the grid holds about ``WAVES`` blocks per SM over
    the whole of S (slots are mostly shorter than S, and blocks past a
    slot's length return at once).  ``chunk`` forces the chunk size.
    """
    gb = min(8, 1 << (G - 1).bit_length())
    nhg = _cdiv(G, gb)
    if chunk is None:
        want = _cdiv(WAVES * n_sm, B * KV * nhg)
        chunk = max(CHUNK_MIN, _cdiv(_cdiv(S, want), CHUNK_ALIGN) * CHUNK_ALIGN)
    elif chunk < 1:
        raise ValueError(f"chunk={chunk} must be >= 1")
    n_split = max(1, _cdiv(S, chunk))
    if n_split > 65535:
        raise ValueError(f"chunk={chunk} cuts S={S} into {n_split} splits, over 65535")
    return gb, nhg, chunk, n_split


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, lengths: torch.Tensor, *,
                     return_lse: bool = False, _chunk: int | None = None):
    """One-token attention of q against the first ``lengths[b]`` cache rows.

    On the serving path ``lengths`` is >= 1 (an empty slot decodes with
    ``cache_len + 1 = 1``); a length of 0 gives zeros (a rank's block of a
    sharded cache that holds none of the sequence).  Returns the output, or
    with ``return_lse`` (output, (B, H) f32 log-sum-exp).  ``_chunk`` forces
    the kernel's chunk of cache rows (tests only).
    """
    _check(q, k_cache, v_cache, lengths)
    if _chunk is not None and _chunk < 1:
        raise ValueError(f"chunk={_chunk} must be >= 1")
    args = (q, k_cache, v_cache, lengths, _chunk or 0, return_lse)
    if all(type(t) is torch.Tensor for t in args[:4]) and q.device.type == "cuda":
        out, lse = _launch(*args)  # a plain CUDA tensor: no dispatcher on the decode path
    elif all(type(t) is torch.Tensor for t in args[:4]):
        out, lse = _plain(*args)
    else:  # fake tensors (the dry-run), or a DTensor, which has no sharding rule: raises
        out, lse = torch.ops.repro_torch.decode_attention(*args)
    return (out, lse) if return_lse else out


def _plain(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor, lengths: torch.Tensor,
           chunk: int, with_lse: bool) -> tuple[torch.Tensor, torch.Tensor]:
    if q.device.type != "cpu":
        raise ValueError(f"decode_attention runs on cpu or cuda tensors, not {q.device.type}")
    decode_attention.plain_calls += 1
    if with_lse:
        return decode_attention_ref(q, k_cache, v_cache, lengths, return_lse=True)
    out = decode_attention_ref(q, k_cache, v_cache, lengths)
    return out, q.new_empty((0,), dtype=torch.float32)


def _fake(q, k_cache, v_cache, lengths, chunk, with_lse):
    return torch.empty_like(q), q.new_empty(q.shape[:2] if with_lse else (0,), dtype=torch.float32)


def _launch(q, k_cache, v_cache, lengths, chunk, with_lse):
    B, H, dh, S, KV = _check(q, k_cache, v_cache, lengths)
    dev = q.device
    esize = q.element_size()
    if dh > MAX_DH or (dh * esize) % 16:
        raise ValueError(f"the CUDA decode_attention needs dh <= {MAX_DH} and "
                         f"dh * {esize} bytes a multiple of 16, got dh={dh}")
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache),
                    ("lengths", lengths)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    out = torch.empty_like(q)
    lse = torch.empty((B, H) if with_lse else (0,), dtype=torch.float32, device=dev)
    if B == 0:
        return out, lse
    gb, nhg, chunk, n_split = _split_plan(B, KV, H // KV, S, _build.sm_count(dev), chunk or None)
    n_bhg = B * KV * nhg
    # per split: m[gb], l[gb], acc[gb][dh] in f32
    part = torch.empty(n_bhg * n_split * gb * (dh + 2) if n_split > 1 else 1,
                       dtype=torch.float32, device=dev)
    rc = _lib()(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), lengths.data_ptr(),
        out.data_ptr(), lse.data_ptr() if with_lse else None, part.data_ptr(),
        _build.counters("decode_attention", dev, n_bhg).data_ptr(),
        B, S, KV, H // KV, gb, dh, chunk, n_split, int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "decode_attention")
    decode_attention.launches += 1
    return out, lse


_op = torch.library.custom_op("repro_torch::decode_attention", _plain, mutates_args=())
_op.register_kernel("cuda")(_launch)
_op.register_fake(_fake)

decode_attention.launches = 0
decode_attention.plain_calls = 0
