"""Hand-written Hopper kernels, each beside its plain PyTorch version.

Every kernel package holds ``ref.py`` (the plain version, used for CPU
tensors) and ``ops.py`` (the wrapper: checks its inputs, runs the plain
version for CPU tensors, launches the CUDA kernel for CUDA tensors).  The
CUDA sources live in ``repro_torch/csrc/`` and are built by ``_build.py``.
"""
