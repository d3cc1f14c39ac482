from repro_torch.kernels.topk_merge.ops import topk_merge
from repro_torch.kernels.topk_merge.ref import topk_merge_ref

__all__ = ["topk_merge", "topk_merge_ref"]
