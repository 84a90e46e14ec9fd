"""K1 on the card: the CUDA kernel against its plain version, bit for bit.

Needs an NVIDIA Hopper card and ``nvcc``; skips elsewhere.  This file
imports no jax (the machine with the card has none), so it runs there
with the repository's conftest left out:

    python -m pytest -q --noconftest -m cuda tests/test_torch_quantize_cuda.py
"""

import pytest
import torch

from repro_torch.hopper.quantize import kernel, ops
from repro_torch.hopper.quantize.ref import quantize_dequantize_ref

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("shape", [(1, 7), (7, 1001), (100, 1728),
                                   (100, 32 * 16 * 16 * 64)])
@pytest.mark.parametrize("bits", [2, 4, 8])
def test_kernel_equals_plain_on_card(cuda, shape, bits):
    g = torch.Generator(device=cuda).manual_seed(bits)
    x = torch.randn(shape, generator=g, device=cuda) * 3.0
    x[0, : shape[1] // 2] = 0.0
    u = torch.rand(shape, generator=g, device=cuda)
    qmax = 2 ** (bits - 1) - 1
    s = ops.tensor_scale(x, qmax)
    before = kernel.launches
    got = ops.quantize_dequantize(x, u, s, qmax)
    assert kernel.launches == before + 1
    want = quantize_dequantize_ref(x, u, s, qmax)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_ste_gradient_on_card(cuda):
    x = torch.randn(4, 1000, device=cuda, requires_grad=True)
    out = ops.quantize_rows(x, torch.Generator(device=cuda).manual_seed(0))
    (g,) = torch.autograd.grad(out.sum(), [x])
    assert torch.equal(g, torch.ones_like(x))


def test_cpu_tensor_never_launches(cuda):
    before = kernel.launches
    ops.quantize_rows(torch.randn(3, 40), torch.Generator().manual_seed(0))
    assert kernel.launches == before
