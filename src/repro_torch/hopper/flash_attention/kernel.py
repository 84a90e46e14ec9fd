"""Build and launch of the Hopper flash attention kernel (K2).

Replaces the Pallas TPU kernel
``src/repro/kernels/flash_attention/kernel.py::flash_attention_hmajor``;
the CUDA source is ``csrc/flash_attention.cu``.  Its bound on the H100 is
operations: 4 d flops per unmasked (q, k) pair at the tensor cores' 989
TFLOP/s in bfloat16.  The bfloat16 path is built for that rate: a block
of three warpgroups, one issuing TMA loads of Q once and of K and V
tiles through an mbarrier ring, two running ``wgmma`` for both Q K^T
(operands in shared memory) and P V (P from registers), with the softmax
in registers and mask code only on the tiles where a mask binds.  The
float32 path runs FMA in full float32.  The tensor maps are built inside
``flash_fwd`` on the host from the strides this wrapper passes, so the
ctypes interface is plain pointers, strides and sizes.

The kernel is built by ``nvcc`` at first use into ``build/`` beside this
file and loaded with ``ctypes`` (``repro_torch.hopper.nvcc``).  Nothing
here touches CUDA or ``nvcc`` at import time, so the CPU-only tests
import the module.

``launches`` counts the kernel launches of this process; callers reset
it to 0 before the run they want to count.
"""

from __future__ import annotations

import ctypes
import math
from pathlib import Path

import torch

from repro_torch.hopper import nvcc

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
BUILD_DIR = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = (*nvcc.ARCH_FLAGS, "-std=c++17", "-O3", "-Xptxas=-v",
              "-shared", "-Xcompiler", "-fPIC")
MAX_HEAD_DIM = 256
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0
build_log = ""           # nvcc's output (ptxas register/spill report)
build_seconds = 0.0      # wall time of the last build (0 when cached)
_lib = None


class FlashParams(ctypes.Structure):
    """Mirror of ``struct FlashParams`` in the CUDA source."""
    _fields_ = [("q", ctypes.c_void_p), ("k", ctypes.c_void_p),
                ("v", ctypes.c_void_p), ("o", ctypes.c_void_p),
                *[(f"{t}_{s}", ctypes.c_int64) for t in "qkvo"
                  for s in ("sb", "ss", "sh")],
                ("batch", ctypes.c_int32), ("seqlen", ctypes.c_int32),
                ("heads", ctypes.c_int32), ("kv_heads", ctypes.c_int32),
                ("head_dim", ctypes.c_int32), ("causal", ctypes.c_int32),
                ("window", ctypes.c_int32), ("softcap", ctypes.c_float),
                ("scale", ctypes.c_float)]


def library_path() -> Path:
    return nvcc.library_path(SOURCE, NVCC_FLAGS, BUILD_DIR, "libflash")


def build() -> Path:
    """Compile the kernel unless this source's library is already built."""
    global build_log, build_seconds
    out, log, build_seconds = nvcc.build(SOURCE, NVCC_FLAGS, BUILD_DIR,
                                         "libflash")
    build_log = log or build_log
    return out


def _library():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        lib.flash_fwd.argtypes = [ctypes.POINTER(FlashParams), ctypes.c_int,
                                  ctypes.c_void_p]
        lib.flash_fwd.restype = ctypes.c_int
        lib.flash_error_string.argtypes = [ctypes.c_int]
        lib.flash_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool, window: int,
                         softcap: float) -> torch.Tensor:
    """Launch K2 on the current stream.  q: (B,S,H,d); k, v: (B,S,KVH,d),
    the model's layout, read through their strides.  The caller (``ops``)
    has checked device, dtype, shapes, head_dim and that the last
    dimension is contiguous (and, for bfloat16, 16-byte aligned rows in a
    layout the TMA tensor maps describe)."""
    global launches
    lib = _library()
    b, s, h, d = q.shape
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    p = FlashParams(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                    *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                    *out.stride()[:3], b, s, h, k.shape[2], d, int(causal),
                    int(window), float(softcap), 1.0 / math.sqrt(d))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_fwd(ctypes.byref(p), DTYPES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"flash attention kernel launch failed: CUDA "
                           f"error {err} "
                           f"({lib.flash_error_string(err).decode()})")
    launches += 1
    return out
