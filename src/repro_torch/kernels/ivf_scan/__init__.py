from repro_torch.kernels.ivf_scan.ops import ivf_scan
from repro_torch.kernels.ivf_scan.ref import ivf_scan_ref

__all__ = ["ivf_scan", "ivf_scan_ref"]
