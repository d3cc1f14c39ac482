from repro_torch.kernels.qk_rope.ops import qk_rope
from repro_torch.kernels.qk_rope.ref import (
    apply_rope_ref,
    qk_rope_ref,
    rms_norm_headwise_ref,
    rope_frequencies,
    scatter_time_ref,
)

__all__ = ["qk_rope", "qk_rope_ref", "apply_rope_ref", "rms_norm_headwise_ref",
           "rope_frequencies", "scatter_time_ref"]
