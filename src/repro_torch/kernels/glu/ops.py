"""Public op: the gated activation of a SwiGLU / GeGLU FFN, ``act(a) * b``.

``glu(a, b, kind=)`` -> a new tensor of a's shape and dtype, ``kind``
"silu" or "gelu" (tanh form).  CPU tensors go to the plain version
(``ref.py``); CUDA tensors launch the Hopper kernel ``csrc/glu.cu`` or
raise (under the private ``kernels._plain.plain_on_card()`` they too take
the plain version).  a and b are contiguous, of one shape and dtype.
``glu.launches`` counts kernel launches and ``glu.plain_calls``
plain-version calls.  The kernel has no backward: the model calls this op
only in its serving modes, and a call that needs a gradient raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, _plain
from repro_torch.kernels.glu.ref import KINDS, glu_ref

_DTYPES = (torch.float32, torch.bfloat16)


def _lib():
    fn = _build.load("glu").glu_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong] + [ctypes.c_int] * 2
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def glu(a: torch.Tensor, b: torch.Tensor, *, kind: str = "silu") -> torch.Tensor:
    if kind not in KINDS:
        raise ValueError(f"kind {kind!r} is not one of {KINDS}")
    if a.shape != b.shape or a.dtype != b.dtype or a.device != b.device:
        raise ValueError(f"a {tuple(a.shape)} {a.dtype} {a.device} and b {tuple(b.shape)} "
                         f"{b.dtype} {b.device} must match")
    if a.device.type == "cuda" and not _plain.active():
        return _launch(a, b, kind)
    if a.device.type not in ("cpu", "cuda"):
        raise ValueError(f"glu runs on cpu or cuda tensors, not {a.device.type}")
    glu.plain_calls += 1
    return glu_ref(a, b, kind=kind)


def _launch(a, b, kind):
    if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
        raise RuntimeError("the CUDA glu has no backward: call the plain chain under autograd")
    if a.dtype not in _DTYPES:
        raise TypeError(f"glu takes f32 or bf16, got {a.dtype}")
    for name, t in (("a", a), ("b", b)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    out = torch.empty_like(a)
    if a.numel():
        rc = _lib()(a.data_ptr(), b.data_ptr(), out.data_ptr(), a.numel(), int(kind == "gelu"),
                    int(a.dtype == torch.bfloat16),
                    torch.cuda.current_stream(a.device).cuda_stream)
        _build.check(rc, "glu")
        glu.launches += 1
    return out


glu.launches = 0
glu.plain_calls = 0
