"""Public op: running top-k merge.

``run_d (Q, k)``, ``run_i (Q, k)``, ``cand_d (Q, m)``, ``cand_i (Q, m)`` ->
``(dists (Q, k) f32, ids (Q, k))``, ids in ``run_i``'s dtype.  CPU tensors go
to the plain version (``ref.py``); CUDA tensors launch the Hopper kernel
``csrc/topk_merge.cu`` or raise.  ``topk_merge.launches`` counts kernel
launches and ``topk_merge.plain_calls`` counts plain-version calls.

The kernel's register path sorts a row in chunks of keys and merges each
into a running list; the chunk is chosen here (``_chunk_plan``) from Q, k,
m and the SM count, and the private ``_chunk=`` forces it (tests only).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.topk_merge.ref import topk_merge_ref

_IDS = (torch.int32, torch.int64)
# chunks of keys the kernel's register path takes (32 x 1..8 keys a lane)
_CHUNKS = (32, 64, 128, 256)
WARPS = 4  # rows a block of the register path (csrc/topk_merge.cu)


def _pow2(n: int) -> int:
    return 1 << max(0, n - 1).bit_length()


def _chunk_plan(Q: int, k: int, m: int, n_sm: int) -> int:
    """Keys a chunk of the kernel's network (k + m keys a row; the kernel
    ignores it for k > 256, where its list lies in shared memory).

    With at most one block an SM, no other warp hides a row's chain of
    dependent steps, so the shortest chain wins: the smallest chunk that
    holds the row, up to 256 (one 64-key sort of 21 steps at the sharded
    search's k 10 + m 30).  With more rows, issue slots bind, so the fewest
    compare-exchanges win: chunks of K' = the next power of two >= k, at
    least 32, merged into a list of K' (4 chunks of 32 at pod scale).
    """
    kp = max(32, _pow2(k))
    if Q <= WARPS * n_sm:
        return max(kp, min(_CHUNKS[-1], _pow2(k + m)))
    return kp


def _lib():
    lib = _build.load("topk_merge")
    fn = lib.topk_merge_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.topk_merge_max_row.argtypes = []
        lib.topk_merge_max_row.restype = ctypes.c_int
    return lib


def _check(run_d, run_i, cand_d, cand_i):
    if run_d.dim() != 2 or cand_d.dim() != 2:
        raise ValueError("run_d must be (Q, k) and cand_d (Q, m)")
    Q, k = run_d.shape
    m = cand_d.shape[1]
    if cand_d.shape[0] != Q or run_i.shape != (Q, k) or cand_i.shape != (Q, m):
        raise ValueError(f"shapes disagree: run {tuple(run_d.shape)}/{tuple(run_i.shape)}, "
                         f"cand {tuple(cand_d.shape)}/{tuple(cand_i.shape)}")
    if run_d.dtype != torch.float32 or cand_d.dtype != torch.float32:
        raise TypeError("run_d and cand_d must be float32")
    if run_i.dtype not in _IDS or cand_i.dtype != run_i.dtype:
        raise TypeError("run_i and cand_i must both be int32 or both int64")
    if k < 1 or m < 1:
        raise ValueError(f"k={k} and m={m} must both be >= 1")
    devs = {t.device for t in (run_d, run_i, cand_d, cand_i)}
    if len(devs) != 1:
        raise ValueError(f"inputs lie on several devices: {sorted(map(str, devs))}")
    return Q, k, m


def topk_merge(run_d: torch.Tensor, run_i: torch.Tensor,
               cand_d: torch.Tensor, cand_i: torch.Tensor, *, _chunk: int | None = None):
    """Merge each row's running top-k with ``m`` candidates into a new top-k.

    See ``ref.py`` for the semantics and ``csrc/topk_merge.cu`` for the kernel.
    ``_chunk`` forces the keys a chunk of the kernel's network holds, one of
    32, 64, 128 or 256 and at least k (tests only).
    """
    Q, k, m = _check(run_d, run_i, cand_d, cand_i)
    dev = run_d.device
    if dev.type == "cpu":
        topk_merge.plain_calls += 1
        return topk_merge_ref(run_d, run_i, cand_d, cand_i)
    if dev.type != "cuda":
        raise ValueError(f"topk_merge runs on cpu or cuda tensors, not {dev.type}")
    lib = _lib()
    kmax = lib.topk_merge_max_row()
    if k > kmax:
        raise ValueError(f"the CUDA topk_merge keeps k <= {kmax}, got {k}")
    if k + m > 2**30:  # positions, and the chunk loop past them, stay ints
        raise ValueError(f"the CUDA topk_merge takes k + m <= 2**30 entries a row, got {k + m}")
    if _chunk is None:
        _chunk = _chunk_plan(Q, k, m, _build.sm_count(dev))
    elif _chunk not in _CHUNKS or _chunk < k:
        raise ValueError(f"_chunk={_chunk} must be one of {_CHUNKS} and >= k={k}")
    for name, t in (("run_d", run_d), ("run_i", run_i), ("cand_d", cand_d), ("cand_i", cand_i)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    out_d = torch.empty((Q, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((Q, k), dtype=run_i.dtype, device=dev)
    if Q == 0:
        return out_d, out_i
    rc = lib.topk_merge_launch(
        run_d.data_ptr(), run_i.data_ptr(), cand_d.data_ptr(), cand_i.data_ptr(),
        out_d.data_ptr(), out_i.data_ptr(), Q, k, m, _chunk, int(run_i.dtype == torch.int64),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "topk_merge")
    topk_merge.launches += 1
    return out_d, out_i


topk_merge.launches = 0
topk_merge.plain_calls = 0
