"""Public op: fused IVF cluster scan.

CPU tensors go to the plain version (``ref.py``); CUDA tensors launch the
Hopper kernel ``csrc/ivf_scan.cu`` or raise.  ``ivf_scan.launches`` counts
kernel launches and ``ivf_scan.plain_calls`` counts plain-version calls.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ivf_scan.ref import ivf_scan_ref

KMAX = 32        # largest k the kernel keeps (workflows use 2..24)
QB_MAX = 16      # largest query group the kernel takes
WARPS = 8        # warps per block in the kernel (its shared-memory layout)
SMEM_MAX = 232_448  # bytes of shared memory a Hopper block can use
_DTYPES = (torch.float32, torch.bfloat16)


def _lib():
    lib = _build.load("ivf_scan")
    fn = lib.ivf_scan_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _check(q_groups, group_cluster, slab, valid, k):
    if q_groups.dim() != 3 or slab.dim() != 3:
        raise ValueError("q_groups must be (G, QB, d) and slab (C, L, d)")
    G, QB, d = q_groups.shape
    C, L, d2 = slab.shape
    if d2 != d:
        raise ValueError(f"query width {d} != slab width {d2}")
    if q_groups.dtype not in _DTYPES or slab.dtype not in _DTYPES:
        raise TypeError("q_groups and slab must be float32 or bfloat16")
    if group_cluster.shape != (G,) or group_cluster.dtype != torch.int32:
        raise ValueError("group_cluster must be (G,) int32")
    if valid.shape != (C,) or valid.dtype != torch.int32:
        raise ValueError("valid must be (C,) int32")
    if not 1 <= k <= L:
        raise ValueError(f"k={k} must lie in [1, L={L}]")
    devs = {t.device for t in (q_groups, group_cluster, slab, valid)}
    if len(devs) != 1:
        raise ValueError(f"inputs lie on several devices: {sorted(map(str, devs))}")
    return G, QB, C, L, d


def ivf_scan(q_groups: torch.Tensor, group_cluster: torch.Tensor,
             slab: torch.Tensor, valid: torch.Tensor, k: int):
    """(G, QB, d), (G,), (C, L, d), (C,) -> (dists (G, QB, k) f32, idx (G, QB, k) i32).

    See ``ref.py`` for the semantics and ``csrc/ivf_scan.cu`` for the kernel.
    """
    G, QB, C, L, d = _check(q_groups, group_cluster, slab, valid, k)
    dev = q_groups.device
    if dev.type == "cpu":
        ivf_scan.plain_calls += 1
        return ivf_scan_ref(q_groups, group_cluster, slab, valid, k)
    if dev.type != "cuda":
        raise ValueError(f"ivf_scan runs on cpu or cuda tensors, not {dev.type}")
    if k > KMAX:
        raise ValueError(f"the CUDA ivf_scan keeps at most k={KMAX}, got {k}")
    if QB > QB_MAX:
        raise ValueError(f"the CUDA ivf_scan takes at most {QB_MAX} queries a group, got {QB}")
    if d % 8:
        raise ValueError(f"the CUDA ivf_scan needs d % 8 == 0, got d={d}")
    qbt = 8 if QB <= 8 else 16
    smem = 4 * (qbt * d + qbt) + 8 * WARPS * qbt * (KMAX + 1)
    if smem > SMEM_MAX:
        raise ValueError(f"d={d} needs {smem} bytes of shared memory, over {SMEM_MAX}")
    for name, t in (("q_groups", q_groups), ("group_cluster", group_cluster),
                    ("slab", slab), ("valid", valid)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    out_d = torch.empty((G, QB, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((G, QB, k), dtype=torch.int32, device=dev)
    if G == 0:
        return out_d, out_i
    rc = _lib()(
        q_groups.data_ptr(), group_cluster.data_ptr(), slab.data_ptr(),
        valid.data_ptr(), out_d.data_ptr(), out_i.data_ptr(),
        G, QB, C, L, d, k,
        int(q_groups.dtype == torch.bfloat16), int(slab.dtype == torch.bfloat16),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "ivf_scan")
    ivf_scan.launches += 1
    return out_d, out_i


ivf_scan.launches = 0
ivf_scan.plain_calls = 0
