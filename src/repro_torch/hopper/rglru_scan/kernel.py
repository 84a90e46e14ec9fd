"""Build and launch of the Hopper RG-LRU scan kernel (K4).

Replaces the Pallas TPU kernel
``src/repro/kernels/rglru_scan/kernel.py::rglru_scan_pallas``; the CUDA
source is ``csrc/rglru_scan.cu``, which states the kernel's bound on the
H100 (bytes: log_a and b read once, h written once) and what its design
does about it (one thread a (batch, width) channel looping over time, a
register tile of time steps loaded ahead of the serial steps).

The kernel is built by ``nvcc`` at first use into ``build/`` beside this
file and loaded with ``ctypes`` (``repro_torch.hopper.nvcc``).  Nothing
here touches CUDA or ``nvcc`` at import time, so the CPU-only tests
import the module.

``launches`` counts the kernel launches of this process; callers reset
it to 0 before the run they want to count.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.hopper import nvcc

SOURCE = Path(__file__).resolve().parent / "csrc" / "rglru_scan.cu"
BUILD_DIR = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = (*nvcc.ARCH_FLAGS, "-std=c++17", "-O3", "-Xptxas=-v",
              "-shared", "-Xcompiler", "-fPIC")
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0
build_log = ""           # nvcc's output (ptxas register/spill report)
build_seconds = 0.0      # wall time of the last build (0 when cached)
_lib = None


class RglruParams(ctypes.Structure):
    """Mirror of ``struct RglruParams`` in the CUDA source."""
    _fields_ = [*[(n, ctypes.c_void_p) for n in ("log_a", "b", "h0", "h")],
                *[(n, ctypes.c_int64) for n in ("la_sb", "la_ss", "b_sb",
                                                "b_ss", "h0_sb", "h_sb",
                                                "h_ss")],
                ("batch", ctypes.c_int32), ("seqlen", ctypes.c_int32),
                ("width", ctypes.c_int32)]


def library_path() -> Path:
    return nvcc.library_path(SOURCE, NVCC_FLAGS, BUILD_DIR, "librglru")


def build() -> Path:
    """Compile the kernel unless this source's library is already built."""
    global build_log, build_seconds
    out, log, build_seconds = nvcc.build(SOURCE, NVCC_FLAGS, BUILD_DIR,
                                         "librglru")
    build_log = log or build_log
    return out


def _library():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        lib.rglru_fwd.argtypes = [ctypes.POINTER(RglruParams), ctypes.c_int,
                                  ctypes.c_int, ctypes.c_void_p]
        lib.rglru_fwd.restype = ctypes.c_int
        lib.rglru_error_string.argtypes = [ctypes.c_int]
        lib.rglru_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def rglru_scan_cuda(log_a: torch.Tensor, b: torch.Tensor,
                    h0: torch.Tensor) -> torch.Tensor:
    """Launch K4 on the current stream.  log_a, b: (B,S,W) float32 or
    bfloat16; h0: (B,W) float32.  Returns h (B,S,W) in log_a's dtype.
    The caller (``ops``) has checked device, dtypes and shapes and that
    the last dimension of every input is contiguous."""
    global launches
    lib = _library()
    bsz, s, w = log_a.shape
    out = torch.empty((bsz, s, w), dtype=log_a.dtype, device=log_a.device)
    p = RglruParams(log_a.data_ptr(), b.data_ptr(), h0.data_ptr(),
                    out.data_ptr(), *log_a.stride()[:2], *b.stride()[:2],
                    h0.stride(0), *out.stride()[:2], bsz, s, w)
    with torch.cuda.device(log_a.device):
        stream = torch.cuda.current_stream(log_a.device).cuda_stream
        err = lib.rglru_fwd(ctypes.byref(p), DTYPES[log_a.dtype],
                            DTYPES[b.dtype], stream)
    if err != 0:
        raise RuntimeError(f"RG-LRU scan kernel launch failed: CUDA error "
                           f"{err} ({lib.rglru_error_string(err).decode()})")
    launches += 1
    return out
