"""Hand-written Hopper kernels, each beside its plain PyTorch version.

Every kernel package holds ``ref.py`` (the plain version, used for CPU
tensors) and ``ops.py`` (the wrapper: checks its inputs, runs the plain
version for CPU tensors, launches the CUDA kernel for CUDA tensors).  The
CUDA sources live in ``repro_torch/csrc/`` and are built by ``_build.py``.
``decode_attention``, ``ivf_scan`` and ``topk_merge`` port the JAX package's
Pallas kernels; ``norm``, ``qk_rope`` and ``glu`` fuse the model body's
elementwise chains, which the JAX package leaves to XLA's fusion.
"""


def wrappers() -> dict:
    """Every kernel wrapper by name; each counts its launches in ``.launches``."""
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.glu import glu
    from repro_torch.kernels.ivf_scan import ivf_scan
    from repro_torch.kernels.norm import norm
    from repro_torch.kernels.qk_rope import qk_rope
    from repro_torch.kernels.topk_merge import topk_merge

    return {"ivf_scan": ivf_scan, "decode_attention": decode_attention,
            "topk_merge": topk_merge, "norm": norm, "qk_rope": qk_rope, "glu": glu}
