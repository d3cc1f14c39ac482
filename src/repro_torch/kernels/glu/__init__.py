from repro_torch.kernels.glu.ops import glu
from repro_torch.kernels.glu.ref import glu_ref

__all__ = ["glu", "glu_ref"]
