"""Build and launch of the Hopper quantize-dequantize kernel (K1).

Replaces the Pallas TPU kernel
``src/repro/kernels/quantize/kernel.py::quantize_dequantize_pallas``; the
CUDA source is ``csrc/quantize.cu``, which states the kernel's bound on
the H100 (memory: 12 bytes moved per element) and what its design does
about it (one streaming pass, 16-byte accesses).

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

SOURCE = Path(__file__).resolve().parent / "csrc" / "quantize.cu"
BUILD_DIR = Path(__file__).resolve().parent / "build"
# --fmad=false on top of the explicit __fmul_rn/__fadd_rn in the source:
# no multiply-add in the file may be contracted, or the result drifts from
# the plain version by one rounding.
NVCC_FLAGS = (*nvcc.ARCH_FLAGS, "-std=c++17", "-O3", "--fmad=false",
              "-Xptxas=-v", "-shared", "-Xcompiler", "-fPIC")

launches = 0
build_log = ""           # nvcc's output (ptxas register/spill report)
build_seconds = 0.0      # wall time of the last build (0 when cached)
_lib = None


def library_path() -> Path:
    return nvcc.library_path(SOURCE, NVCC_FLAGS, BUILD_DIR, "libquantize")


def build() -> Path:
    """Compile the kernel unless this source's library is already built."""
    global build_log, build_seconds
    out, log, build_seconds = nvcc.build(SOURCE, NVCC_FLAGS, BUILD_DIR,
                                         "libquantize")
    build_log = log or build_log
    return out


def _library():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        # every pointer and the stream as c_void_p: a bare Python int would
        # be passed as a 32-bit C int and cut the address
        lib.qdq_f32.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                ctypes.c_void_p, ctypes.c_void_p,
                                ctypes.c_int64, ctypes.c_int64,
                                ctypes.c_float, ctypes.c_void_p]
        lib.qdq_f32.restype = ctypes.c_int
        lib.qdq_error_string.argtypes = [ctypes.c_int]
        lib.qdq_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def quantize_dequantize_cuda(x: torch.Tensor, u: torch.Tensor,
                             scale: torch.Tensor, qmax: int) -> torch.Tensor:
    """Launch K1 on the current stream.  The caller (``ops``) has checked
    that x, u are contiguous (R, n) float32, scale (R,) float32, all on one
    CUDA device."""
    global launches
    lib = _library()
    out = torch.empty_like(x)
    rows, n = x.shape
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.qdq_f32(x.data_ptr(), u.data_ptr(), scale.data_ptr(),
                          out.data_ptr(), rows, n, float(qmax), stream)
    if err != 0:
        raise RuntimeError(f"quantize kernel launch failed: CUDA error {err} "
                           f"({lib.qdq_error_string(err).decode()})")
    launches += 1
    return out
