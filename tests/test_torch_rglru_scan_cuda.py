"""K4 on the card: the CUDA RG-LRU scan kernel against its plain version on
the same inputs.

Needs an NVIDIA Hopper card and ``nvcc``; skips elsewhere.  This file
imports no jax (the machine with the card has none), so it runs there
with the repository's conftest left out:

    python -m pytest -q --noconftest -m cuda tests/test_torch_rglru_scan_cuda.py

Tolerances: the reference's 1e-4 in float32 and 5e-2 for bfloat16
(tests/test_kernels.py:75).  The kernel rounds the product and the sum of
each step as the plain version does; only expf and torch's exp may round
an ulp apart.
"""

import pytest
import torch

from repro_torch.hopper.rglru_scan import kernel, ops
from repro_torch.hopper.rglru_scan.ref import rglru_scan_ref

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 1e-4, torch.bfloat16: 5e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _inputs(cuda, b, s, w, dtype, b_dtype=None, seed=0):
    """log_a <= 0 and b in the given dtypes, h0 float32, drawn as the
    reference's sweep draws them (tests/test_kernels.py:70-72)."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    la = -torch.randn(b, s, w, generator=g, device=cuda).abs() * 0.1
    bb = torch.randn(b, s, w, generator=g, device=cuda)
    h0 = torch.randn(b, w, generator=g, device=cuda)
    return la.to(dtype), bb.to(b_dtype or dtype), h0


def _check(log_a, b, h0):
    before = kernel.launches
    got = ops.rglru_scan(log_a, b, h0)
    assert kernel.launches == before + 1
    want = rglru_scan_ref(log_a, b, h0)
    torch.cuda.synchronize()
    assert got.dtype == log_a.dtype and got.shape == log_a.shape
    tol = TOL[log_a.dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("b,s,w", [
    (2, 128, 64), (1, 256, 512), (3, 64, 128),   # the reference's sweep
    (6, 160, 256),                   # the reduced model's head bank
    (2, 512, 2560),                  # full width's lru_width
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain_on_card(cuda, b, s, w, dtype):
    _check(*_inputs(cuda, b, s, w, dtype))


@pytest.mark.parametrize("s,w", [(1, 64), (31, 100), (33, 7), (1000, 130)])
def test_ragged_lengths_and_widths_on_card(cuda, s, w):
    """S no multiple of the kernel's 32-step tile (and shorter than one);
    W no multiple of a warp or a block."""
    _check(*_inputs(cuda, 2, s, w, torch.float32, seed=s))


@pytest.mark.parametrize("la_dtype,b_dtype", [
    (torch.bfloat16, torch.float32), (torch.float32, torch.bfloat16)])
def test_mixed_dtypes_on_card(cuda, la_dtype, b_dtype):
    _check(*_inputs(cuda, 2, 96, 64, la_dtype, b_dtype, seed=5))


def test_strided_inputs_on_card(cuda):
    """log_a and b as halves of one (B,S,2W) tensor and h0 as a column
    slice: read in place through their batch and time strides."""
    g = torch.Generator(device=cuda).manual_seed(3)
    both = torch.randn(2, 80, 2 * 48, generator=g, device=cuda)
    both[..., :48] = -both[..., :48].abs() * 0.1
    h0s = torch.randn(2, 3 * 48, generator=g, device=cuda)
    la, bb, h0 = both[..., :48], both[..., 48:], h0s[:, 48:96]
    assert not la.is_contiguous() and not h0.is_contiguous()
    _check(la, bb, h0)


def test_backward_matches_plain_autograd_on_card(cuda):
    x = _inputs(cuda, 2, 48, 40, torch.float32, seed=2)
    w = torch.randn_like(x[0])
    leaves = [t.clone().requires_grad_() for t in x]
    (ops.rglru_scan(*leaves) * w).sum().backward()
    ref_leaves = [t.clone().requires_grad_() for t in x]
    (rglru_scan_ref(*ref_leaves) * w).sum().backward()
    for a, b in zip(leaves, ref_leaves):
        torch.testing.assert_close(a.grad, b.grad, rtol=1e-4, atol=1e-4)


def test_cpu_tensor_never_launches(cuda):
    before = kernel.launches
    ops.rglru_scan(-torch.rand(1, 8, 4), torch.randn(1, 8, 4),
                   torch.zeros(1, 4))
    assert kernel.launches == before
