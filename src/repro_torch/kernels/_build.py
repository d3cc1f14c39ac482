"""Build the CUDA kernels with ``nvcc`` and load them through ``ctypes``.

Each source ``repro_torch/csrc/<name>.cu`` exports a plain C entry point and
is compiled on its own into ``build/kernels/lib<name>-<hash>.so`` with::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v

No PyTorch header is included, so a build takes seconds.  The hash covers
the source and the flags, so a library is rebuilt only when either changes.
Builds start on the first CUDA tensor that reaches a kernel (or through
``build()``); several sources compile in parallel, one ``nvcc`` each.
``nvcc`` is looked up on ``PATH``, then under ``$CUDA_HOME/bin``.

Two launch helpers shared by the wrappers sit at the end: the card's SM
count (to size a split grid) and the per-device completion counters of the
kernels that combine across blocks.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

KERNELS = ("ivf_scan", "decode_attention", "topk_merge", "norm", "qk_rope", "glu")
CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def find_nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").is_file():
        return str(Path(home) / "bin" / "nvcc")
    raise RuntimeError(
        "nvcc was not found on PATH or under $CUDA_HOME/bin; the CUDA kernels "
        "of repro_torch cannot be built")


def _target(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names=KERNELS) -> dict[str, float]:
    """Compile every named kernel that is not built yet, all in parallel.

    Returns the seconds each build took (0.0 for one already built).  The
    compiler's output, including ``-Xptxas -v``'s register and shared-memory
    report, is kept in ``build/kernels/<name>.log``.  Raises if a build fails.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = None
    procs = {}
    for name in names:
        out = _target(name)
        if out.exists():
            continue
        nvcc = nvcc or find_nvcc()
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        procs[name] = (proc, tmp, out, time.perf_counter())
    took = {name: 0.0 for name in names}
    failed = []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        took[name] = time.perf_counter() - t0
        (BUILD_DIR / f"{name}.log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{name} (exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)  # atomic: a concurrent build never sees half a file
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return took


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build((name,))
            lib = ctypes.CDLL(str(_target(name)))
            _libs[name] = lib
        return lib


def check(rc: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")


_sm_counts: dict[int, int] = {}
_counters: dict[tuple[str, int], torch.Tensor] = {}
_outgrown: list[torch.Tensor] = []


def sm_count(dev) -> int:
    """Streaming multiprocessors of CUDA device ``dev`` (a host property,
    read once: no device sync)."""
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    n = _sm_counts.get(idx)
    if n is None:
        n = _sm_counts[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return n


def counters(name: str, dev, n: int):
    """``n`` int32 completion counters of kernel ``name`` on ``dev``, zero
    between launches: allocated once per device and reused, since every
    launch that counts leaves them at zero again.  Launches of one kernel
    must therefore not run concurrently on two streams of one device.  A
    buffer outgrown by a larger launch is kept, never freed: a captured
    CUDA graph may still launch with its address."""
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    t = _counters.get((name, idx))
    if t is None or t.numel() < n:
        if t is not None:
            _outgrown.append(t)
        size = max(n, 2 * t.numel() if t is not None else 1024)
        t = _counters[(name, idx)] = torch.zeros(size, dtype=torch.int32,
                                                 device=torch.device("cuda", idx))
    return t
