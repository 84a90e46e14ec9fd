"""K2 on the card: the CUDA flash attention kernel against its plain
version on the same inputs.

Needs an NVIDIA Hopper card and ``nvcc``; skips elsewhere.  This file
imports no jax (the machine with the card has none), so it runs there
with the repository's conftest left out:

    python -m pytest -q --noconftest -m cuda tests/test_torch_flash_attention_cuda.py

Tolerances are the reference's (tests/test_kernels.py:34): 2e-5 in
float32 (summation order; the float32 path is full float32 FMA), 2e-2 in
bfloat16 (the kernel rounds the probabilities to bfloat16 for the
tensor-core PV product, and the output to bfloat16).
"""

import pytest
import torch

from repro_torch.hopper.flash_attention import kernel, ops
from repro_torch.hopper.flash_attention.ref import attention_ref

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _qkv(cuda, b, s, h, kvh, d, dtype, seed=0):
    g = torch.Generator(device=cuda).manual_seed(seed)
    return tuple(torch.randn(b, s, n, d, generator=g, device=cuda)
                 .to(dtype) for n in (h, kvh, kvh))


def _plain(q, k, v, **kw):
    out = attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                        v.transpose(1, 2), **kw)
    return out.transpose(1, 2)


def _check(q, k, v, **kw):
    before = kernel.launches
    got = ops.flash_attention(q, k, v, **kw)
    assert kernel.launches == before + 1
    want = _plain(q, k, v, **kw)
    torch.cuda.synchronize()
    assert got.dtype == q.dtype and got.shape == q.shape
    tol = TOL[q.dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("b,h,kvh,s,d", [
    (2, 4, 2, 256, 64),
    (1, 4, 4, 512, 32),
    (1, 2, 1, 128, 128),
    (1, 4, 2, 320, 256),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 64), (False, 0)])
def test_kernel_matches_plain_on_card(cuda, b, h, kvh, s, d, dtype, causal,
                                      window):
    _check(*_qkv(cuda, b, s, h, kvh, d, dtype), causal=causal,
           window=window)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s,window,causal,softcap", [
    (100, 0, True, 0.0),        # ragged: no multiple of any tile
    (100, 7, True, 0.0),
    (32, 64, True, 0.0),        # the head bank at the reference's size
    (256, 0, True, 20.0),       # softcap
    (96, 20, False, 0.0),       # a window without causality
])
def test_kernel_edge_cases_on_card(cuda, dtype, s, window, causal, softcap):
    _check(*_qkv(cuda, 2, s, 4, 2, 64, dtype, seed=s), causal=causal,
           window=window, softcap=softcap)


def test_strided_inputs_on_card(cuda):
    """q, k, v as slices of one fused projection: strided rows, read in
    place (no copy) by the kernel."""
    g = torch.Generator(device=cuda).manual_seed(1)
    qkv = torch.randn(2, 128, 8, 64, generator=g, device=cuda)
    q, k, v = qkv[:, :, :4], qkv[:, :, 4:6], qkv[:, :, 6:]
    _check(q, k, v, causal=True, window=0)


def test_backward_matches_plain_autograd_on_card(cuda):
    q, k, v = _qkv(cuda, 1, 64, 4, 2, 32, torch.float32, seed=2)
    w = torch.randn_like(q)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    (ops.flash_attention(*leaves, causal=True, window=16) * w).sum().backward()
    ref_leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    (_plain(*ref_leaves, causal=True, window=16) * w).sum().backward()
    for a, b in zip(leaves, ref_leaves):
        torch.testing.assert_close(a.grad, b.grad, rtol=1e-4, atol=1e-4)


def test_cpu_tensor_never_launches(cuda):
    before = kernel.launches
    ops.flash_attention(torch.randn(1, 8, 2, 16), torch.randn(1, 8, 1, 16),
                        torch.randn(1, 8, 1, 16))
    assert kernel.launches == before


# The bf16 kernel's tile edges: 128 query rows a block (two warpgroups of
# 64), 64 keys a tile, d in 64-column TMA boxes (zero-filled below the
# template's 64, 128 or 256).
@pytest.mark.parametrize("s", [1, 63, 65, 127, 129, 2049])
@pytest.mark.parametrize("d", [32, 64, 128, 256])
def test_bf16_tile_edges_on_card(cuda, s, d):
    """Ragged lengths around the query and key tiles, every head width
    template, GQA 2:1, causal."""
    _check(*_qkv(cuda, 1, s, 4, 2, d, torch.bfloat16, seed=s + d),
           causal=True, window=0)


@pytest.mark.parametrize("s,causal,window", [
    (129, True, 0),
    (300, False, 0),
    (2049, True, 2048),          # recurrentgemma's window, binding
])
def test_bf16_mqa_on_card(cuda, s, causal, window):
    """MQA 10:1, recurrentgemma-2b's ten query heads over one kv head."""
    _check(*_qkv(cuda, 2, s, 10, 1, 256, torch.bfloat16, seed=s),
           causal=causal, window=window)


@pytest.mark.parametrize("window", [40, 64, 100, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_bf16_window_edges_on_card(cuda, window, causal):
    """A window edge inside a key tile (40, 100) and on a tile edge (64,
    128), with and without causality."""
    _check(*_qkv(cuda, 2, 333, 4, 2, 128, torch.bfloat16, seed=window),
           causal=causal, window=window)


@pytest.mark.parametrize("d", [64, 256])
def test_bf16_softcap_on_card(cuda, d):
    _check(*_qkv(cuda, 1, 257, 4, 2, d, torch.bfloat16, seed=d),
           causal=True, window=0, softcap=30.0)


@pytest.mark.parametrize("d", [64, 256])
def test_bf16_strided_inputs_on_card(cuda, d):
    """q, k, v as slices of one fused bf16 projection: the tensor maps
    carry the fused buffer's head, row and batch strides."""
    g = torch.Generator(device=cuda).manual_seed(d)
    qkv = torch.randn(2, 129, 8, d, generator=g, device=cuda).to(
        torch.bfloat16)
    q, k, v = qkv[:, :, :4], qkv[:, :, 4:6], qkv[:, :, 6:]
    _check(q, k, v, causal=True, window=0)
    _check(q, k, v, causal=False, window=50)


# F1: K2's backward above DENSE_MAX_SEQ tokens recomputes by query blocks.
# One float32 (B, H, S, S) logits tensor of the dense recompute at gemma3's
# 16 query heads and S = 8192: 4.29 GB.
DENSE_LOGITS_BYTES = 16 * 8192 * 8192 * 4


@pytest.mark.parametrize("window", [0, 1024])
def test_long_backward_memory_is_bounded_on_card(cuda, monkeypatch, window):
    """One gemma3-width layer (16 query heads over 8 kv heads of 256),
    S = 8192, bf16, global and window 1024: the blocked recompute's peak
    allocation stays below one dense logits tensor, and its gradients
    agree with the dense recompute's (forced by raising the threshold)
    within K2's bf16 tolerance."""
    from repro_torch.models import attention
    q, k, v = _qkv(cuda, 1, 8192, 16, 8, 256, torch.bfloat16, seed=window)
    g = torch.randn_like(q)

    def grads():
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        ops.flash_attention(*leaves, causal=True, window=window).backward(g)
        return [t.grad for t in leaves]

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    blocked = grads()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    assert peak < DENSE_LOGITS_BYTES, peak
    monkeypatch.setattr(attention, "DENSE_MAX_SEQ", 8192)
    dense = grads()
    for a, b in zip(blocked, dense):
        assert a.dtype == torch.bfloat16 and torch.isfinite(a).all()
        torch.testing.assert_close(a.float(), b.float(),
                                   rtol=TOL[torch.bfloat16],
                                   atol=TOL[torch.bfloat16])
