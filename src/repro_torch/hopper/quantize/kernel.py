"""Build and launch of the Hopper quantize-dequantize kernel (K1).

Replaces the Pallas TPU kernel
``src/repro/kernels/quantize/kernel.py::quantize_dequantize_pallas``; the
CUDA source is ``csrc/quantize.cu``, which states the kernel's bound on
the H100 (memory: 12 bytes moved per element) and what its design does
about it (one streaming pass, 16-byte accesses).

The kernel is compiled with ``nvcc`` at first use into a shared library
with a plain C interface and loaded with ``ctypes``: no PyTorch headers,
so the build takes seconds.  The library goes into ``build/`` beside this
file, named by a hash of the source and flags, so an edited source never
meets a stale build.  Nothing here touches CUDA or ``nvcc`` at import
time, so the CPU-only tests import the module.

``launches`` counts the kernel launches of this process; callers reset
it to 0 before the run they want to count.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

SOURCE = Path(__file__).resolve().parent / "csrc" / "quantize.cu"
BUILD_DIR = Path(__file__).resolve().parent / "build"
# --fmad=false on top of the explicit __fmul_rn/__fadd_rn in the source:
# no multiply-add in the file may be contracted, or the result drifts from
# the plain version by one rounding.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xptxas=-v", "-shared",
              "-Xcompiler", "-fPIC")

launches = 0
build_log = ""           # nvcc's output (ptxas register/spill report)
build_seconds = 0.0      # wall time of the last build (0 when cached)
_lib = None


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (looked on PATH and in CUDA_HOME); "
                       "the quantize kernel is built from source at first "
                       "use")


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"libquantize_{digest[:16]}.so"


def build() -> Path:
    """Compile the kernel unless this source's library is already built."""
    global build_log, build_seconds
    out = library_path()
    if out.exists():
        build_seconds = 0.0
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    # compile to a private name, then rename: a concurrent builder never
    # loads a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, str(SOURCE)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    build_seconds = time.perf_counter() - t0
    build_log = proc.stdout + proc.stderr
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
