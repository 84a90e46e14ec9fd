"""Port parity for ``models/attention.py``: the attention sublayer over a
full sequence (local and global, GQA, the flash path and the dense path)
and the multi-step KV-cache decode with its ring buffer, against the JAX
package with the reference's own parameters (``attn_init``) carried in
through ``convert``.

Tolerance 2e-5 in float32 (the reference's flash tolerance: summation
order in the projections and the softmax).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_arch as j_get_arch
from repro.models import attention as ja
from repro_torch.configs.registry import get_arch
from repro_torch.convert import params_from_numpy
from repro_torch.hopper.flash_attention import kernel
from repro_torch.models import attention as ta

TOL = 2e-5


def _cfgs(kv_heads):
    j_cfg = j_get_arch("gemma3-12b").reduced(num_layers=12)
    cfg = get_arch("gemma3-12b").reduced(num_layers=12)
    if kv_heads != j_cfg.num_kv_heads:
        j_cfg = dataclasses.replace(j_cfg, num_kv_heads=kv_heads)
        cfg = dataclasses.replace(cfg, num_kv_heads=kv_heads)
    return j_cfg, cfg


def _params(j_cfg, seed=0):
    jp = ja.attn_init(jax.random.PRNGKey(seed), j_cfg)
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def _x(shape, seed=1):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("kv_heads", [4, 2])
@pytest.mark.parametrize("window", [0, 64])
@pytest.mark.parametrize("impl", ["auto", "dense"])
def test_attn_apply_matches_reference(kv_heads, window, impl):
    """S = 150: past the window of 64 and no multiple of a tile.  The port's
    "auto" is the flash wrapper (its plain version on the CPU); the
    reference's "auto" at this length is its dense path."""
    j_cfg, cfg = _cfgs(kv_heads)
    jp, tp = _params(j_cfg)
    x = _x((2, 150, cfg.d_model))
    theta = cfg.local_rope_theta if window else cfg.rope_theta
    want = ja.attn_apply(jp, j_cfg, jnp.asarray(x), window=window,
                         rope_theta=theta, impl="dense")
    before = kernel.launches
    got = ta.attn_apply(tp, cfg, torch.from_numpy(x), window=window,
                        rope_theta=theta, impl=impl)
    assert kernel.launches == before
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


def test_self_attention_rejects_an_unknown_impl():
    q = torch.randn(1, 4, 2, 16)
    with pytest.raises(ValueError):
        ta.self_attention(q, q, q, impl="chunked")


@pytest.mark.parametrize("offset", [0, 5])
def test_dense_attention_offset_and_valid_mask(offset):
    r = np.random.default_rng(2)
    q = r.normal(size=(2, 6, 4, 16)).astype(np.float32)
    k = r.normal(size=(2, 11, 2, 16)).astype(np.float32)
    v = r.normal(size=(2, 11, 2, 16)).astype(np.float32)
    valid = r.random(size=(2, 11)) > 0.3
    valid[:, 0] = True
    kw = dict(causal=True, window=4, softcap=30.0)
    want = ja.dense_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              q_offset=offset, kv_valid=jnp.asarray(valid),
                              **kw)
    got = ta.dense_attention(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v), q_offset=offset,
                             kv_valid=torch.from_numpy(valid), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("window", [0, 8])
def test_decode_attend_ring_buffer_matches_reference(window):
    """20 one-token steps into a cache of max_len 20: the windowed layer
    keeps a ring of 8 slots, so its slots wrap twice.  Each step's output
    and the cache after it against the reference; and each step's output
    against the full-sequence layer at that position (the decode path and
    the flash path compute the same attention)."""
    j_cfg, cfg = _cfgs(2)
    jp, tp = _params(j_cfg, seed=3)
    steps = 20
    x = _x((2, steps, cfg.d_model), seed=4)
    theta = cfg.local_rope_theta if window else cfg.rope_theta
    jc = ja.init_kv_cache(j_cfg, 2, steps, window=window, dtype=jnp.float32)
    tc = ta.init_kv_cache(cfg, 2, steps, window=window, dtype=torch.float32)
    assert tuple(tc["k"].shape) == jc["k"].shape
    full = ta.attn_apply(tp, cfg, torch.from_numpy(x), window=window,
                         rope_theta=theta)
    for i in range(steps):
        xi = x[:, i:i + 1]
        jy, jc = ja.decode_attend(jp, j_cfg, jnp.asarray(xi), jc,
                                  jnp.asarray(i, jnp.int32), window=window,
                                  rope_theta=theta)
        ty, tc = ta.decode_attend(tp, cfg, torch.from_numpy(xi), tc, i,
                                  window=window, rope_theta=theta)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=TOL,
                                   atol=TOL, err_msg=f"step {i}")
        np.testing.assert_allclose(tc["k"].numpy(), np.asarray(jc["k"]),
                                   rtol=TOL, atol=TOL, err_msg=f"step {i}")
        np.testing.assert_allclose(ty[:, 0].numpy(), full[:, i].numpy(),
                                   rtol=TOL, atol=TOL, err_msg=f"step {i}")
