"""K2's backward above ``DENSE_MAX_SEQ`` on the CPU: the recompute by
query blocks (``hopper/flash_attention/ops._blocked_grads``) against
``jax.vjp`` of the reference's long-sequence paths, ``chunked_attention``
and ``banded_attention`` (``repro/models/attention.py``), and against the
port's own dense recompute, on the same numpy-made inputs.

The thresholds are patched down (``DENSE_MAX_SEQ`` 32, ``Q_CHUNK`` 16) so
that tiny widths reach the blocked path; the reference's chunks are
passed as arguments.  Tolerance: 1e-4, the one the wrapper's gradient
test uses (tests/test_torch_flash_attention.py): float32 on both sides,
sums in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.attention import banded_attention, chunked_attention
from repro_torch.hopper.flash_attention import kernel, ops
from repro_torch.models import attention

GRAD_TOL = 1e-4
CASES = {          # (causal, window, softcap)
    "causal": (True, 0, 0.0),
    "window": (True, 16, 0.0),
    "softcap": (True, 0, 20.0),
    "noncausal": (False, 0, 0.0),
}


def _inputs(s, seed=0, b=2, h=4, kvh=2, d=16):
    r = np.random.default_rng(seed)
    q = r.normal(size=(b, s, h, d)).astype(np.float32)
    k = r.normal(size=(b, s, kvh, d)).astype(np.float32)
    v = r.normal(size=(b, s, kvh, d)).astype(np.float32)
    wt = r.normal(size=q.shape).astype(np.float32)
    return q, k, v, wt


def _port_grads(q, k, v, wt, causal, window, softcap, dtype=torch.float32):
    leaves = [torch.from_numpy(a).to(dtype).requires_grad_()
              for a in (q, k, v)]
    out = ops.flash_attention(*leaves, causal, window, softcap)
    (out.float() * torch.from_numpy(wt)).sum().backward()
    return [t.grad for t in leaves]


@pytest.fixture
def small_blocks(monkeypatch):
    monkeypatch.setattr(attention, "DENSE_MAX_SEQ", 32)
    monkeypatch.setattr(attention, "Q_CHUNK", 16)


@pytest.mark.parametrize("case", list(CASES))
def test_blocked_backward_matches_reference_vjp(small_blocks, case):
    """S = 64 > the patched 32: the port recomputes by blocks of 16 rows;
    the reference's VJP goes through its banded path on the windowed
    layer and its chunked path otherwise (chunks of 16)."""
    causal, window, softcap = CASES[case]
    q, k, v, wt = _inputs(64, seed=len(case))

    def ref(q_, k_, v_):
        if window:
            return banded_attention(q_, k_, v_, window=window,
                                    softcap=softcap, q_chunk=16)
        return chunked_attention(q_, k_, v_, causal=causal, window=window,
                                 softcap=softcap, q_chunk=16, kv_chunk=16)

    _, vjp = jax.vjp(ref, *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(wt))
    before = kernel.launches
    got = _port_grads(q, k, v, wt, causal, window, softcap)
    assert kernel.launches == before
    for name, a, b in zip("qkv", got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=GRAD_TOL,
                                   atol=GRAD_TOL, err_msg=f"d{name}")


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("s", [64, 70])
def test_blocked_backward_matches_dense_recompute(monkeypatch, case, s):
    """The same gradients with the threshold patched (blocks of 16, and a
    ragged last block at S = 70) and left as it is (one dense recompute);
    the blocked path's dense calls never see more than 16 query rows."""
    causal, window, softcap = CASES[case]
    q, k, v, wt = _inputs(s, seed=s)
    dense = _port_grads(q, k, v, wt, causal, window, softcap)
    rows = []
    orig = attention.dense_attention

    def counted(q_, *a, **kw):
        rows.append(q_.shape[1])
        return orig(q_, *a, **kw)

    monkeypatch.setattr(attention, "dense_attention", counted)
    monkeypatch.setattr(attention, "DENSE_MAX_SEQ", 32)
    monkeypatch.setattr(attention, "Q_CHUNK", 16)
    blocked = _port_grads(q, k, v, wt, causal, window, softcap)
    assert rows == [16] * (s // 16) + ([s % 16] if s % 16 else [])
    for name, a, b in zip("qkv", blocked, dense):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=GRAD_TOL,
                                   atol=GRAD_TOL, err_msg=f"d{name}")


def test_blocked_backward_bfloat16_matches_dense(monkeypatch):
    """bf16 leaves: the blocked path sums dk and dv in float32 and rounds
    once, so it agrees with the dense recompute to one bf16 step."""
    q, k, v, wt = _inputs(64, seed=9)
    dense = _port_grads(q, k, v, wt, True, 16, 0.0, torch.bfloat16)
    monkeypatch.setattr(attention, "DENSE_MAX_SEQ", 32)
    monkeypatch.setattr(attention, "Q_CHUNK", 16)
    blocked = _port_grads(q, k, v, wt, True, 16, 0.0, torch.bfloat16)
    for a, b in zip(blocked, dense):
        assert a.dtype == torch.bfloat16
        np.testing.assert_allclose(a.float().numpy(), b.float().numpy(),
                                   rtol=2e-2, atol=2e-2)


def test_thresholds_are_the_reference_constants():
    from repro.models import attention as j_attention
    assert attention.DENSE_MAX_SEQ == j_attention.DENSE_MAX_SEQ == 4096
    assert attention.Q_CHUNK == j_attention.Q_CHUNK == 1024
