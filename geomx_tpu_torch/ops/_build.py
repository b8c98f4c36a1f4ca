"""Builds the port's CUDA kernels from ``geomx_tpu_torch/csrc`` at first use.

One ``torch.utils.cpp_extension.load`` call compiles every source for
``sm_90a`` (Hopper) into ``build/torch_kernels`` beside the package —
a directory ``.gitignore`` lists — and imports the result.  Only
``binding.cpp`` includes ``torch/extension.h``; the ``.cu`` files expose
a plain C interface (``geomx_kernels.h``), so they compile in seconds
and the one slow PyTorch-header compile runs beside them under ninja.

Nothing here runs at import: the CPU tests import every module of the
port, and a build starts only when a wrapper meets a CUDA tensor.  A
failed build raises; no caller falls back to a plain version.
"""

from __future__ import annotations

import os
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
SOURCES = ("binding.cpp", "bucket.cu", "bsc.cu", "optim.cu", "twobit.cu",
           "merge.cu")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "torch_kernels")

CUDA_FLAGS = ("-O3", "-gencode=arch=compute_90a,code=sm_90a")

_lock = threading.Lock()
_ext = None
build_seconds = None  # wall time of the build in this process, once done


def kernels(verbose: bool = False):
    """The compiled extension module (built once per process)."""
    global _ext, build_seconds
    with _lock:
        if _ext is None:
            from torch.utils.cpp_extension import load
            os.makedirs(BUILD_DIR, exist_ok=True)
            flags = list(CUDA_FLAGS)
            if verbose:
                flags.append("-Xptxas=-v")
            t0 = time.perf_counter()
            _ext = load(name="geomx_tpu_torch_kernels",
                        sources=[os.path.join(CSRC, s) for s in SOURCES],
                        build_directory=BUILD_DIR,
                        extra_cflags=["-O2"],
                        extra_cuda_cflags=flags,
                        extra_include_paths=[CSRC],
                        verbose=verbose)
            build_seconds = time.perf_counter() - t0
    return _ext
