"""Public op: RMSNorm / LayerNorm over the last dim, with an optional
residual add before it.

``norm(x, scale, bias, kind=, eps=, delta=)`` -> y, or (x + delta, y) with
``delta``.  CPU tensors go to the plain version (``ref.py``); CUDA tensors
launch the Hopper kernel ``csrc/norm.cu`` or raise (under the private
``kernels._plain.plain_on_card()`` they too take the plain version).  x may
be any (..., d) whose rows flatten to one stride with the last dim
contiguous (MLA's latent, a slice of a wider product); delta must be
contiguous and of x's shape and dtype.  ``norm.launches`` counts kernel
launches and ``norm.plain_calls`` plain-version calls.

The kernel has no backward: the model calls this op only in its serving
modes, and a call that needs a gradient raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, _plain
from repro_torch.kernels.norm.ref import KINDS, norm_ref

_DTYPES = (torch.float32, torch.bfloat16)
_lib = None  # (norm_launch, norm_max_d()), bound once
# launch arguments by (x dtype, scale dtype, bias dtype, kind, d), each
# validated once: what the kernel can take depends on these alone
_plans: dict[tuple, tuple[int, int, int]] = {}


def _launcher():
    global _lib
    if _lib is None:
        lib = _build.load("norm")
        fn = lib.norm_launch
        fn.argtypes = ([ctypes.c_void_p, ctypes.c_longlong] + [ctypes.c_void_p] * 5
                       + [ctypes.c_int, ctypes.c_int, ctypes.c_float]
                       + [ctypes.c_int] * 3 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.norm_max_d.restype = ctypes.c_int
        _lib = (fn, lib.norm_max_d())
    return _lib


def _check(x, scale, bias, kind, delta):
    if kind not in KINDS:
        raise ValueError(f"kind {kind!r} is not one of {KINDS}")
    if (kind == "layernorm") != (bias is not None):
        raise ValueError("LayerNorm takes a bias and RMSNorm none")
    d = x.shape[-1]
    for name, p in (("scale", scale), ("bias", bias)):
        if p is not None and p.shape != (d,):
            raise ValueError(f"{name} {tuple(p.shape)} does not match the last dim {d}")
    if delta is not None and (delta.shape != x.shape or delta.dtype != x.dtype):
        raise ValueError(f"delta {tuple(delta.shape)} {delta.dtype} must match x "
                         f"{tuple(x.shape)} {x.dtype}")
    devs = {t.device for t in (x, scale, bias, delta) if t is not None}
    if len(devs) != 1:
        raise ValueError(f"inputs lie on several devices: {sorted(map(str, devs))}")


def norm(x: torch.Tensor, scale: torch.Tensor, bias=None, *, kind: str = "rmsnorm",
         eps: float, delta=None):
    if x.device.type == "cuda" and not _plain.active():
        return _launch(x, scale, bias, kind, eps, delta)
    _check(x, scale, bias, kind, delta)
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"norm runs on cpu or cuda tensors, not {x.device.type}")
    norm.plain_calls += 1
    return norm_ref(x, scale, bias, kind=kind, eps=eps, delta=delta)


def _plan(x, scale, bias, kind):
    """(layernorm, x_bf16, p_bf16) for the kernel, or raise on what it cannot take."""
    if x.dtype not in _DTYPES or scale.dtype not in _DTYPES or (
            bias is not None and bias.dtype != scale.dtype):
        raise TypeError(f"norm takes f32 or bf16 activations and parameters, got {x.dtype}, "
                        f"{scale.dtype}")
    d = x.shape[-1]
    vec = 16 // x.element_size()
    max_d = _launcher()[1]
    if d % vec or d > max_d:
        raise ValueError(f"the CUDA norm needs d a multiple of {vec} and at most {max_d}, got {d}")
    return int(kind == "layernorm"), int(x.dtype == torch.bfloat16), int(scale.dtype == torch.bfloat16)


def _launch(x, scale, bias, kind, eps, delta):
    _check(x, scale, bias, kind, delta)
    key = (x.dtype, scale.dtype, None if bias is None else bias.dtype, kind, x.shape[-1])
    plan = _plans.get(key)
    if plan is None:
        plan = _plans[key] = _plan(x, scale, bias, kind)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in (x, scale, bias, delta)):
        raise RuntimeError("the CUDA norm has no backward: call the plain chain under autograd")
    d = x.shape[-1]
    try:
        x2 = x.view(-1, d)
    except RuntimeError as e:  # rows that do not flatten to one stride
        raise ValueError(f"x {tuple(x.shape)} with strides {x.stride()} is not rows of one "
                         "stride") from e
    if x2.stride(1) != 1 or (x2.stride(0) * x.element_size()) % 16 or x2.data_ptr() % 16:
        raise ValueError("x's rows must be 16-byte aligned with the last dim contiguous")
    for name, t in (("scale", scale), ("bias", bias), ("delta", delta)):
        if t is not None and (not t.is_contiguous() or t.data_ptr() % 16):
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    rows = x2.shape[0]
    y = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    res = torch.empty_like(y) if delta is not None else None
    if rows:
        rc = _launcher()[0](
            x2.data_ptr(), x2.stride(0), None if delta is None else delta.data_ptr(),
            None if res is None else res.data_ptr(), y.data_ptr(), scale.data_ptr(),
            None if bias is None else bias.data_ptr(), rows, d, eps, *plan,
            torch.cuda.current_stream(x.device).cuda_stream)
        _build.check(rc, "norm")
        norm.launches += 1
    return y if delta is None else (res, y)


norm.launches = 0
norm.plain_calls = 0
