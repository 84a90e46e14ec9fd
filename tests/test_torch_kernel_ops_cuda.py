"""The kernels' custom ops on the card (``repro_torch.hopper.dispatch``):
each kernel's fake registration gives the real output's shape and dtype,
and its flop formula gives the operation count of PERF.md §6's bound.

Needs an NVIDIA Hopper card and ``nvcc``; skips elsewhere.  This file
imports no jax (the machine with the card has none), so it runs there
with the repository's conftest left out:

    python -m pytest -q --noconftest -m cuda tests/test_torch_kernel_ops_cuda.py
"""

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.hopper.flash_attention import kernel as fa_kernel
from repro_torch.hopper.flash_attention import ops as fa_ops
from repro_torch.hopper.mlstm_chunk import ops as ml_ops
from repro_torch.hopper.mlstm_chunk.ref import KERNEL_CHUNK
from repro_torch.hopper.quantize import ops as q_ops
from repro_torch.hopper.rglru_scan import ops as rg_ops

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _flash_pairs(s, causal, window):
    """PERF.md §6's pairs: each query's keys from the window's left edge
    to itself (to the end without causality), counted one by one."""
    return sum((q + 1 if causal else s) - (max(0, q - window + 1)
                                            if window else 0)
               for q in range(s))


def _mlstm_flops(b, s, h, dh):
    lens = [min(KERNEL_CHUNK, s - c) for c in range(0, s, KERNEL_CHUNK)]
    return b * h * sum(2 * dh * n * (n + 1) + 4 * n * dh * dh for n in lens)


def _run(fn, *args):
    """(real output, fake output, the fake run's FLOPs)."""
    real = fn(*args)
    torch.cuda.synchronize()
    with FakeTensorMode() as mode:
        fake_args = [mode.from_tensor(a) if isinstance(a, torch.Tensor)
                     else a for a in args]
        with FlopCounterMode(display=False) as fc:
            fake = fn(*fake_args)
    return real, fake, fc.get_total_flops()


@pytest.mark.parametrize("s,causal,window", [(256, True, 0),
                                             (300, True, 64),
                                             (256, False, 0),
                                             (200, False, 48)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_op(cuda, s, causal, window, dtype):
    b, h, kvh, d = 2, 4, 2, 64
    g = torch.Generator(device=cuda).manual_seed(0)
    q = torch.randn(b, s, h, d, generator=g, device=cuda).to(dtype)
    k = torch.randn(b, s, kvh, d, generator=g, device=cuda).to(dtype)
    v = torch.randn(b, s, kvh, d, generator=g, device=cuda).to(dtype)
    before = fa_kernel.launches
    real, fake, flops = _run(lambda *a: fa_ops.flash_attention(
        *a, causal=causal, window=window), q, k, v)
    assert fa_kernel.launches == before + 1      # the fake run launches none
    assert (fake.shape, fake.dtype, fake.device) == (real.shape, real.dtype,
                                                     real.device)
    assert flops == 4 * d * _flash_pairs(s, causal, window) * b * h
    assert fa_ops.attention_pairs(s, causal, window) == \
        _flash_pairs(s, causal, window)


def test_quantize_op(cuda):
    x = torch.randn(3, 1000, device=cuda)
    u = torch.rand(3, 1000, device=cuda)
    scale = q_ops.tensor_scale(x, 127)
    real, fake, flops = _run(lambda *a: q_ops.quantize_dequantize(*a, 127),
                             x, u, scale)
    assert (fake.shape, fake.dtype) == (real.shape, real.dtype)
    assert flops == 5 * x.numel()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mlstm_chunk_op(cuda, dtype):
    b, s, h, dh = 2, 300, 2, 64
    g = torch.Generator(device=cuda).manual_seed(1)
    q, k, v = (torch.randn(b, s, h, dh, generator=g, device=cuda).to(dtype)
               for _ in range(3))
    li = torch.randn(b, s, h, generator=g, device=cuda)
    lf = -torch.rand(b, s, h, generator=g, device=cuda)
    real, fake, flops = _run(ml_ops.mlstm_chunk, q, k, v, li, lf)
    assert (fake.shape, fake.dtype) == (real.shape, real.dtype)
    assert flops == _mlstm_flops(b, s, h, dh)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rglru_scan_op(cuda, dtype):
    g = torch.Generator(device=cuda).manual_seed(2)
    la = (-torch.rand(2, 128, 256, generator=g, device=cuda) * 0.1).to(dtype)
    bb = torch.randn(2, 128, 256, generator=g, device=cuda).to(dtype)
    h0 = torch.randn(2, 256, generator=g, device=cuda)
    real, fake, flops = _run(rg_ops.rglru_scan, la, bb, h0)
    assert (fake.shape, fake.dtype) == (real.shape, real.dtype)
    assert flops == 3 * la.numel()
