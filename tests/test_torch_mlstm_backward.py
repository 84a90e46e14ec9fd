"""The mLSTM chunk wrapper's backward at a training length where the
chunkwise form's masked half overflows (R4 in ROADMAP.md).

D[t, s] = exp(g_s - M_t) is selected to the causal half s <= t.  For
s > t the exponent grows with the sum of the forget gates' logs over the
chunk (about 0.7 a step at the models' initialisation, so past float32's
88.7 within a chunk of 128).  The reference selects after the exp, so
its VJP multiplies the masked half's zero cotangent by inf: NaN
gradients, and ``repro.launch.train --seq 256`` trains to NaN.  The port
selects -inf before the exp: the same forward, and gradients that match
autograd through the step-by-step recurrence in float64 (which has no
masked half).  Tolerance: the reference's mLSTM 2e-4
(tests/test_kernels.py:104), relative to each gradient's largest
element.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.mlstm_chunk.ref import mlstm_ref as j_mlstm_ref
from repro_torch.hopper.mlstm_chunk import ops

TOL = 2e-4


def _inputs(seed, b=1, s=256, h=2, dh=32, lf_shift=-1.0):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, s, h, dh)).astype(np.float32)
               for _ in range(3))
    k /= np.sqrt(dh)
    li = rng.standard_normal((b, s, h)).astype(np.float32)
    pre = rng.standard_normal((b, s, h)) + lf_shift
    lf = (-np.logaddexp(0.0, -pre)).astype(np.float32)   # log sigmoid
    return q, k, v, li, lf


def _recurrent64(q, k, v, li, lf):
    """h (B,S,H,dh) by the O(1) recurrence, out of place, in float64."""
    b, s, h, dh = q.shape
    C = q.new_zeros((b, h, dh, dh))
    n = q.new_zeros((b, h, dh))
    m = q.new_full((b, h), -1e30)
    out = []
    for t in range(s):
        m_new = torch.maximum(lf[:, t] + m, li[:, t])
        fg = torch.exp(lf[:, t] + m - m_new)
        ig = torch.exp(li[:, t] - m_new)
        C = fg[..., None, None] * C + ig[..., None, None] * (
            k[:, t, :, :, None] * v[:, t, :, None, :])
        n = fg[..., None] * n + ig[..., None] * k[:, t]
        num = torch.einsum("bhd,bhde->bhe", q[:, t], C)
        den = torch.maximum(torch.einsum("bhd,bhd->bh", q[:, t], n).abs(),
                            torch.exp(-m_new))
        out.append(num / den[..., None])
        m = m_new
    return torch.stack(out, dim=1)


def _masked_half_overflows(lf, chunk=128):
    a = np.cumsum(lf.reshape(lf.shape[0], -1, chunk, lf.shape[-1]), axis=2)
    return float((a[:, :, :1] - a[:, :, -1:]).max()) > 88.8


@pytest.mark.parametrize("seed", [0, 1])
def test_reference_vjp_is_nan_where_the_masked_half_overflows(seed):
    """R4: the reference's own VJP (``jax.vjp(mlstm_ref)``, what its
    kernel wrapper differentiates) at these inputs."""
    q, k, v, li, lf = _inputs(seed)
    assert _masked_half_overflows(lf)
    hm = lambda t: jnp.swapaxes(jnp.asarray(t), 1, 2)     # noqa: E731
    out, vjp = jax.vjp(j_mlstm_ref, hm(q), hm(k), hm(v), hm(li), hm(lf))
    assert np.isfinite(np.asarray(out)).all()
    grads = vjp(jnp.ones_like(out))
    assert any(np.isnan(np.asarray(g)).any() for g in grads)


@pytest.mark.parametrize("seed", [0, 1])
def test_port_backward_is_finite_and_matches_the_recurrence(seed):
    arrays = _inputs(seed)
    assert _masked_half_overflows(arrays[4])
    leaves = [torch.from_numpy(a).requires_grad_() for a in arrays]
    out = ops.mlstm_chunk(*leaves)
    g_out = torch.from_numpy(np.random.default_rng(seed + 9)
                             .standard_normal(out.shape).astype(np.float32))
    got = torch.autograd.grad(out, leaves, g_out)
    ref = [torch.from_numpy(a).double().requires_grad_() for a in arrays]
    want_out = _recurrent64(*ref)
    want = torch.autograd.grad(want_out, ref, g_out.double())
    scale = want_out.abs().max().item()
    np.testing.assert_allclose(out.detach().double().numpy(),
                               want_out.detach().numpy(), rtol=0,
                               atol=TOL * scale)
    for name, g, w in zip(("q", "k", "v", "li", "lf"), got, want):
        assert torch.isfinite(g).all(), name
        err = (g.double() - w).abs().max().item()
        assert err <= TOL * w.abs().max().item(), (name, err)


def test_forward_unchanged_against_reference():
    """Selecting before the exp leaves the forward as the reference's
    selection after it gives it, within the reference's 2e-4."""
    q, k, v, li, lf = _inputs(3)
    hm = lambda t: jnp.swapaxes(jnp.asarray(t), 1, 2)     # noqa: E731
    want = np.swapaxes(np.asarray(j_mlstm_ref(hm(q), hm(k), hm(v), hm(li),
                                              hm(lf))), 1, 2)
    got = ops.mlstm_chunk(*(torch.from_numpy(a) for a in (q, k, v, li, lf)))
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)
