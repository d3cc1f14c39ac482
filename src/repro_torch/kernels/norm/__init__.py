from repro_torch.kernels.norm.ops import norm
from repro_torch.kernels.norm.ref import norm_ref

__all__ = ["norm", "norm_ref"]
