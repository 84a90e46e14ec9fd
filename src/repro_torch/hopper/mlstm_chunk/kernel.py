"""Build and launch of the Hopper mLSTM chunk kernel (K3).

Replaces the Pallas TPU kernel
``src/repro/kernels/mlstm_chunk/kernel.py::mlstm_chunk_pallas``; the CUDA
source is ``csrc/mlstm_chunk.cu``, which states the kernel's bound on the
H100 (operations: QK^T, (S.D)V, DK, QC and K^T V per chunk) and what its
design does about it (a v-split of the dh x dh state across blocks, a
loop over the chunks inside the block, one pass over dh per chunk, float32
FMA).

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

SOURCE = Path(__file__).resolve().parent / "csrc" / "mlstm_chunk.cu"
BUILD_DIR = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = (*nvcc.ARCH_FLAGS, "-std=c++17", "-O3", "-Xptxas=-v",
              "-shared", "-Xcompiler", "-fPIC")
MAX_HEAD_DIM = 512       # the C tile (dh x 32 float32) fits in shared memory
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0
build_log = ""           # nvcc's output (ptxas register/spill report)
build_seconds = 0.0      # wall time of the last build (0 when cached)
_lib = None


class MlstmParams(ctypes.Structure):
    """Mirror of ``struct MlstmParams`` in the CUDA source."""
    _fields_ = [*[(n, ctypes.c_void_p) for n in ("q", "k", "v", "li", "lf",
                                                  "o")],
                *[(f"{t}_{s}", ctypes.c_int64)
                  for t in ("q", "k", "v", "li", "lf", "o")
                  for s in ("sb", "ss", "sh")],
                ("batch", ctypes.c_int32), ("seqlen", ctypes.c_int32),
                ("heads", ctypes.c_int32), ("head_dim", ctypes.c_int32)]


def library_path() -> Path:
    return nvcc.library_path(SOURCE, NVCC_FLAGS, BUILD_DIR, "libmlstm")


def build() -> Path:
    """Compile the kernel unless this source's library is already built."""
    global build_log, build_seconds
    out, log, build_seconds = nvcc.build(SOURCE, NVCC_FLAGS, BUILD_DIR,
                                         "libmlstm")
    build_log = log or build_log
    return out


def _library():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        lib.mlstm_fwd.argtypes = [ctypes.POINTER(MlstmParams), ctypes.c_int,
                                  ctypes.c_void_p]
        lib.mlstm_fwd.restype = ctypes.c_int
        lib.mlstm_error_string.argtypes = [ctypes.c_int]
        lib.mlstm_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def mlstm_chunk_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     li: torch.Tensor, lf: torch.Tensor) -> torch.Tensor:
    """Launch K3 on the current stream.  q, k, v: (B,S,H,dh); li, lf:
    (B,S,H) float32 — the model's layout, read through their strides.
    The caller (``ops``) has checked device, dtypes, shapes, head_dim and
    that the last dimension of q, k, v is contiguous."""
    global launches
    lib = _library()
    b, s, h, d = q.shape
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    p = MlstmParams(q.data_ptr(), k.data_ptr(), v.data_ptr(), li.data_ptr(),
                    lf.data_ptr(), out.data_ptr(), *q.stride()[:3],
                    *k.stride()[:3], *v.stride()[:3], *li.stride(),
                    *lf.stride(), *out.stride()[:3], b, s, h, d)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.mlstm_fwd(ctypes.byref(p), DTYPES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"mLSTM chunk kernel launch failed: CUDA error "
                           f"{err} ({lib.mlstm_error_string(err).decode()})")
    launches += 1
    return out
