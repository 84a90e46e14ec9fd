"""K3 on the card: the CUDA mLSTM chunk kernel against its plain version on
the same inputs.

Needs an NVIDIA Hopper card and ``nvcc``; skips elsewhere.  This file
imports no jax (the machine with the card has none), so it runs there
with the repository's conftest left out:

    python -m pytest -q --noconftest -m cuda tests/test_torch_mlstm_chunk_cuda.py

Tolerances: the reference's 2e-4 (tests/test_kernels.py:104) in float32
(the kernel sums in another order, takes chunks of 64 against the plain
version's 128, and folds q . n_intra into the row sums of QK^T . D); for
bfloat16 inputs one bfloat16 step (2^-7 relative) on top of it, since
both compute in float32 (the bf16 kernel's non-bf16 operands split into
bf16 hi and lo, about 2^-17 relative) and round the output once.

The bf16 kernel's tile edges are held to the plain version run on the
inputs padded with zero rows to a multiple of its chunk (128) and cut
back: rows after t do not change h_t, and the plain version's own
fallback at a ragged length, one quadratic chunk, sums the forget gates
over the whole sequence in float32 and drifts by more than a bf16 step
from the exact result at S = 2049.
"""

import pytest
import torch
import torch.nn.functional as F

from repro_torch.hopper.mlstm_chunk import kernel, ops
from repro_torch.hopper.mlstm_chunk.ref import KERNEL_CHUNK, mlstm_ref

pytestmark = pytest.mark.cuda

TOL = 2e-4
BF16_RTOL = 2.0 ** -7


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(cuda, b, s, h, dh, dtype, seed=0):
    """q, k, v (B,S,H,dh) in ``dtype`` and float32 gates (B,S,H), drawn as
    the reference's sweep draws them (k scaled by 1/sqrt(dh), lf a log
    sigmoid)."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    q = torch.randn(b, s, h, dh, generator=g, device=cuda)
    k = torch.randn(b, s, h, dh, generator=g, device=cuda) / dh ** 0.5
    v = torch.randn(b, s, h, dh, generator=g, device=cuda)
    li = torch.randn(b, s, h, generator=g, device=cuda)
    lf = F.logsigmoid(torch.randn(b, s, h, generator=g, device=cuda))
    return q.to(dtype), k.to(dtype), v.to(dtype), li, lf


def _plain(q, k, v, li, lf):
    return mlstm_ref(*(t.transpose(1, 2) for t in (q, k, v, li, lf))
                     ).transpose(1, 2)


def _plain_chunked(q, k, v, li, lf):
    """The plain version at its chunk of 128 on zero rows padded to a
    multiple of it, cut back to S."""
    s = q.shape[1]
    pad = -s % KERNEL_CHUNK
    padded = [F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
              for t in (q, k, v, li, lf)]
    return _plain(*padded)[:, :s]


def _check(q, k, v, li, lf, plain=_plain):
    before = kernel.launches
    got = ops.mlstm_chunk(q, k, v, li, lf)
    assert kernel.launches == before + 1
    want = plain(q, k, v, li, lf)
    torch.cuda.synchronize()
    assert got.dtype == q.dtype and got.shape == q.shape
    rtol = TOL if q.dtype == torch.float32 else BF16_RTOL
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=TOL)


@pytest.mark.parametrize("b,h,s,dh", [
    (2, 2, 128, 32), (1, 4, 256, 64), (1, 1, 64, 16),   # the reference's
    (2, 2, 160, 256),                                   # reduced model's dh
    (1, 2, 256, 512),                                   # full width's dh
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain_on_card(cuda, b, h, s, dh, dtype):
    _check(*_inputs(cuda, b, s, h, dh, dtype))


@pytest.mark.parametrize("s,dh", [(1, 32), (100, 48), (333, 64)])
def test_ragged_lengths_on_card(cuda, s, dh):
    """S no multiple of the kernel's chunk (64) nor the plain version's
    (128); dh no multiple of the 32-wide v-tile."""
    _check(*_inputs(cuda, 2, s, 2, dh, torch.float32, seed=s))


def test_strided_inputs_on_card(cuda):
    """q, k, v as slices of one fused projection and gates as slices of
    one (B,S,2H) tensor: read in place through their strides."""
    g = torch.Generator(device=cuda).manual_seed(3)
    qkv = torch.randn(2, 128, 2, 3 * 32, generator=g, device=cuda)
    q, k, v = qkv[..., :32], qkv[..., 32:64] / 32 ** 0.5, qkv[..., 64:]
    gates = torch.randn(2, 128, 4, generator=g, device=cuda)
    _check(q, k.contiguous(), v, gates[..., :2], F.logsigmoid(gates[..., 2:]))


@pytest.mark.parametrize("s", [63, 64, 65, 255, 256, 257, 2049])
@pytest.mark.parametrize("dh", [16, 20, 48, 256, 512])
def test_bf16_tile_edges_on_card(cuda, s, dh):
    """The bf16 passes' edges: lengths around the 64-row tiles and the
    256-row state chunks (one row past a boundary state, one short of
    one), head widths below a 64-column box (16), not a multiple of 8
    (20, padded with zero columns), inside one box (48), and the reduced
    and full models' 256 and 512."""
    _check(*_inputs(cuda, 1, s, 2, dh, torch.bfloat16, seed=s + dh),
           plain=_plain_chunked)


def test_bf16_strided_inputs_on_card(cuda):
    """bf16 q, k, v as slices of one fused (B,S,H,3 dh) buffer, read in
    place by the TMA tensor maps, over two state chunks."""
    g = torch.Generator(device=cuda).manual_seed(4)
    qkv = torch.randn(2, 300, 2, 3 * 64, generator=g, device=cuda)
    qkv[..., 64:128] /= 8.0
    qkv = qkv.to(torch.bfloat16)
    q, k, v = qkv[..., :64], qkv[..., 64:128], qkv[..., 128:]
    gates = torch.randn(2, 300, 4, generator=g, device=cuda)
    _check(q, k, v, gates[..., :2], F.logsigmoid(gates[..., 2:]),
           plain=_plain_chunked)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_launch_count_moves_by_one_a_call(cuda, dtype):
    """One count a call, whichever route and however many CUDA kernels
    (the bf16 route issues three at S > 256)."""
    x = _inputs(cuda, 1, 600, 2, 64, dtype)
    before = kernel.launches
    for i in range(3):
        ops.mlstm_chunk(*x)
        assert kernel.launches == before + i + 1
    torch.cuda.synchronize()


def test_backward_matches_plain_autograd_on_card(cuda):
    x = _inputs(cuda, 1, 64, 2, 16, torch.float32, seed=2)
    w = torch.randn_like(x[0])
    leaves = [t.clone().requires_grad_() for t in x]
    (ops.mlstm_chunk(*leaves) * w).sum().backward()
    ref_leaves = [t.clone().requires_grad_() for t in x]
    (_plain(*ref_leaves) * w).sum().backward()
    for a, b in zip(leaves, ref_leaves):
        torch.testing.assert_close(a.grad, b.grad, rtol=TOL, atol=TOL)


def test_cpu_tensor_never_launches(cuda):
    before = kernel.launches
    ops.mlstm_chunk(*(torch.randn(1, 8, 2, 16) for _ in range(3)),
                    torch.randn(1, 8, 2), torch.randn(1, 8, 2))
    assert kernel.launches == before
