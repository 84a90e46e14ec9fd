"""Build and launch of the Hopper mLSTM chunk kernel (K3).

Replaces the Pallas TPU kernel
``src/repro/kernels/mlstm_chunk/kernel.py::mlstm_chunk_pallas``; the CUDA
source is ``csrc/mlstm_chunk.cu``, which states the function's bound on
the H100 and what each path's design does about it.  The route is by
dtype: bfloat16 q, k, v take three CUDA kernels, the products on the
tensor cores with wgmma and TMA (the gates; the states at the boundaries
of 256-row chunks; the outputs), for which this wrapper allocates the
workspaces; float32 takes one CUDA-core
FMA kernel (a v-split of the dh x dh state across blocks, 64-row chunks
walked inside the block).

The kernels are built by ``nvcc`` at first use into ``build/`` beside this
file and loaded with ``ctypes`` (``repro_torch.hopper.nvcc``).  Nothing
here touches CUDA or ``nvcc`` at import time, so the CPU-only tests
import the module.

``launches`` counts calls of ``mlstm_chunk_cuda`` (one each, whichever
route and however many CUDA kernels it issues) in this process; callers
reset it to 0 before the run they want to count.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.hopper import nvcc
from repro_torch.hopper.mlstm_chunk.ref import STATE_CHUNK

SOURCE = Path(__file__).resolve().parent / "csrc" / "mlstm_chunk.cu"
BUILD_DIR = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = (*nvcc.ARCH_FLAGS, "-std=c++17", "-O3", "-Xptxas=-v",
              "-shared", "-Xcompiler", "-fPIC")
MAX_HEAD_DIM = 512       # float32: the C tile (dh x 32) fits in shared memory
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
GATE_PLANES = 6          # bf16: float32 gate rows a (b, h) (the .cu's kPlanes)
BF16_WIDTHS = (64, 128, 256, 512)   # bf16: the output pass's templates
BF16_PASSES = ("gates", "states", "outputs")   # bf16: its CUDA kernels

launches = 0
build_log = ""           # nvcc's output (ptxas register/spill report)
build_seconds = 0.0      # wall time of the last build (0 when cached)
_lib = None


class MlstmParams(ctypes.Structure):
    """Mirror of ``struct MlstmParams`` in the CUDA source."""
    _fields_ = [*[(n, ctypes.c_void_p) for n in ("q", "k", "v", "li", "lf",
                                                  "o", "gates", "states",
                                                  "norms")],
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
        lib.mlstm_bf16_pass.argtypes = lib.mlstm_fwd.argtypes
        lib.mlstm_bf16_pass.restype = ctypes.c_int
        lib.mlstm_error_string.argtypes = [ctypes.c_int]
        lib.mlstm_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _ptr(t):
    """A workspace's address, or NULL where there is none (float32) or it
    is empty (one chunk: no boundary state)."""
    return None if t is None or t.numel() == 0 else t.data_ptr()


def bf16_head_dim(d: int) -> int:
    """The head width the bf16 passes take for a head of ``d``: ``d``
    itself where it is a multiple of 8 (TMA's 16-byte rule) within 64 of
    a template width (so every 64-column box holds some of it), else that
    width; the wrapper pads q, k and v with zero columns up to it."""
    width = next(w for w in BF16_WIDTHS if w >= d)
    return d if d % 8 == 0 and d > width - 64 else width


def _prepare(q, k, v, li, lf):
    """The launch's params, with the output and the workspaces they point
    to (kept alive with them), and the head width to slice back to."""
    b, s, h, d = q.shape
    dk = d
    gates = states = norms = None
    if q.dtype == torch.bfloat16:
        # Zero columns change neither Q K^T, Q C nor q . n, and the output
        # columns past d are sliced off.
        dk = bf16_head_dim(d)
        if dk != d:
            q, k, v = (torch.nn.functional.pad(t, (0, dk - d))
                       for t in (q, k, v))
        chunks = -(-s // STATE_CHUNK)
        # the planes' width: the head's rounded up to 64 columns (the
        # .cu's pad64; the states pass tiles them 64 x 64 at dp = 64,
        # 128 x 128 above)
        dp = -(-dk // 64) * 64
        gates = torch.empty(b * h * GATE_PLANES * chunks * STATE_CHUNK,
                            dtype=torch.float32, device=q.device)
        states = torch.empty(b * h * (chunks - 1) * 2 * dp * dp,
                             dtype=torch.bfloat16, device=q.device)
        norms = torch.empty(b * h * (chunks - 1) * 2 * dp,
                            dtype=torch.bfloat16, device=q.device)
    out = torch.empty((b, s, h, dk), dtype=q.dtype, device=q.device)
    p = MlstmParams(q.data_ptr(), k.data_ptr(), v.data_ptr(), li.data_ptr(),
                    lf.data_ptr(), out.data_ptr(), _ptr(gates), _ptr(states),
                    _ptr(norms), *q.stride()[:3], *k.stride()[:3],
                    *v.stride()[:3], *li.stride(), *lf.stride(),
                    *out.stride()[:3], b, s, h, dk)
    return p, out, (q, k, v, gates, states, norms), d


def _call(fn, p, device, arg):
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(ctypes.byref(p), arg, stream)
    if err != 0:
        raise RuntimeError(f"mLSTM chunk kernel launch failed: error {err} "
                           f"({_library().mlstm_error_string(err).decode()})")


def mlstm_chunk_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     li: torch.Tensor, lf: torch.Tensor) -> torch.Tensor:
    """Launch K3 on the current stream.  q, k, v: (B,S,H,dh); li, lf:
    (B,S,H) float32 — the model's layout, read through their strides.
    The caller (``ops``) has checked device, dtypes, shapes and head_dim,
    made the last dimension of q, k, v contiguous and, in bfloat16, laid
    them out as the TMA tensor maps read them."""
    global launches
    lib = _library()
    p, out, _keep, d = _prepare(q, k, v, li, lf)
    _call(lib.mlstm_fwd, p, q.device, DTYPES[q.dtype])
    launches += 1
    return out if out.shape[3] == d else out[..., :d].contiguous()


def bf16_passes(q, k, v, li, lf):
    """One callable for each of ``BF16_PASSES``, each launching that bf16
    pass alone on one set of workspaces, for timing the passes apart: run
    them in order once before timing any alone.  They do not count in
    ``launches``.  q, k, v as ``mlstm_chunk_cuda`` takes them, bf16."""
    lib = _library()
    p, out, keep, _ = _prepare(q, k, v, li, lf)

    def run(i):
        def launch():
            _call(lib.mlstm_bf16_pass, p, q.device, i)
            return out, keep
        return launch
    return [run(i) for i in range(len(BF16_PASSES))]
