"""Port parity for ``models/xlstm.py``: the mLSTM and sLSTM blocks at
``xlstm-350m.reduced()`` (d_model 256, 2 heads: mLSTM heads of 256,
sLSTM heads of 128) against ``repro.models.xlstm`` on the same numpy
inputs, with the reference's own parameters carried in; then the
properties the reference's tests/test_recurrent.py holds (chunkwise =
recurrent, chunk-size invariance, an O(1) cache), and a multi-token
decode against the full forward, which shows the in-place cache writes
take effect.

Tolerances (float32): 1e-4 on the block outputs (projections summed in
another order, then a recurrence over up to 80 steps); the reference's
2e-4 on the bare mLSTM forms (tests/test_recurrent.py).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_arch as j_get_arch
from repro.models import build_model as j_build
from repro.models import xlstm as jx
from repro_torch.configs.registry import get_arch
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.hopper.mlstm_chunk import kernel
from repro_torch.models import init_utils
from repro_torch.models import xlstm as tx
from repro_torch.models.registry import build_model
from repro_torch.utils.tree import tree_leaves_with_path

TOL = 1e-4
REC_TOL = 2e-4


@pytest.fixture(scope="module")
def cfgs():
    return j_get_arch("xlstm-350m").reduced(), get_arch("xlstm-350m").reduced()


def _params(init, j_cfg, seed):
    jp = init(jax.random.PRNGKey(seed), j_cfg)
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def _x(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, want, tol=TOL, msg=""):
    np.testing.assert_allclose(got.detach().numpy() if isinstance(
        got, torch.Tensor) else got, np.asarray(want), rtol=tol, atol=tol,
        err_msg=msg)


# --------------------------------------------------------------- mLSTM -----
@pytest.mark.parametrize("s", [32, 80, 512])
def test_mlstm_block_matches_reference(cfgs, s):
    """S = 32 and 80: one quadratic chunk on both sides; S = 512: two of
    the model's 256-token chunks on the reference side, four of K3's
    plain version's 128 here (impl "auto" on a CPU tensor), and the
    model's own 256 with impl "dense"."""
    j_cfg, cfg = cfgs
    jp, tp = _params(jx.mlstm_init, j_cfg, 0)
    x = _x((2, s, cfg.d_model), s)
    want, _ = jx.mlstm_block_apply(jp, j_cfg, jnp.asarray(x))
    before = kernel.launches
    got, cache = tx.mlstm_block_apply(tp, cfg, torch.from_numpy(x))
    assert cache is None and kernel.launches == before
    _close(got, want)
    plain, _ = tx.mlstm_block_apply(tp, cfg, torch.from_numpy(x),
                                    impl="dense")
    _close(plain, want)
    with pytest.raises(ValueError, match="impl"):
        tx.mlstm_block_apply(tp, cfg, torch.from_numpy(x), impl="flash")


def test_mlstm_heads_and_casts_match_reference(cfgs):
    """q, k (divided by sqrt(dh)), v and the float32 gates, and the conv
    state the projection leaves behind."""
    j_cfg, cfg = cfgs
    jp, tp = _params(jx.mlstm_init, j_cfg, 1)
    di = int(cfg.d_model * cfg.xlstm.proj_factor_mlstm)
    x_m = _x((2, 24, di), 2)
    state = _x((2, cfg.xlstm.conv_kernel - 1, di), 3)
    want = jx._mlstm_heads(jp, j_cfg, jnp.asarray(x_m), jnp.asarray(state))
    got = tx._mlstm_heads(tp, cfg, torch.from_numpy(x_m),
                          torch.from_numpy(state))
    for name, a, b in zip(("q", "k", "v", "li", "lf", "conv"), got, want):
        assert a.dtype == getattr(torch, str(b.dtype)), name
        _close(a, b, 1e-5, name)


def test_mlstm_decode_matches_reference_step_by_step(cfgs):
    """Twelve one-token steps through the block with its cache, on both
    sides: the port writes its cache in place and returns the same
    object; the reference returns a new one.  Both caches agree after
    every step."""
    j_cfg, cfg = cfgs
    jp, tp = _params(jx.mlstm_init, j_cfg, 4)
    x = _x((2, 12, cfg.d_model), 5)
    jc = jx.init_mlstm_cache(j_cfg, 2)
    tc = tx.init_mlstm_cache(cfg, 2)
    ids = {id(t) for _, t in tree_leaves_with_path(tc)}
    for t in range(x.shape[1]):
        want, jc = jx.mlstm_block_apply(jp, j_cfg, jnp.asarray(x[:, t:t + 1]),
                                        cache=jc, index=t)
        got, out = tx.mlstm_block_apply(tp, cfg, torch.from_numpy(
            x[:, t:t + 1]), cache=tc, index=t)
        assert out is tc
        _close(got, want, msg=f"step {t}")
        want_c = dict(tree_leaves_with_path(_np(jc)))
        got_c = dict(tree_leaves_with_path(tc))
        assert set(got_c) == set(want_c)
        for path, a in got_c.items():
            _close(a, want_c[path], msg=f"step {t} cache {path}")
    assert {id(t) for _, t in tree_leaves_with_path(tc)} == ids


def test_mlstm_chunkwise_matches_recurrent():
    """tests/test_recurrent.py:15-36, with the port's forms."""
    b, s, h, dh = 2, 64, 2, 16
    r = np.random.default_rng(0)
    q = torch.from_numpy(r.normal(size=(b, s, h, dh)).astype(np.float32))
    k = torch.from_numpy(r.normal(size=(b, s, h, dh)).astype(np.float32)) \
        / math.sqrt(dh)
    v = torch.from_numpy(r.normal(size=(b, s, h, dh)).astype(np.float32))
    li = torch.from_numpy(r.normal(size=(b, s, h)).astype(np.float32))
    lf = torch.nn.functional.logsigmoid(torch.from_numpy(
        r.normal(size=(b, s, h)).astype(np.float32)))
    out_chunk, (C, n, m) = tx.mlstm_chunkwise(q, k, v, li, lf, chunk=16)
    carry = (torch.zeros(b, h, dh, dh), torch.zeros(b, h, dh),
             torch.full((b, h), -1e30))
    outs = []
    for t in range(s):
        o, carry = tx.mlstm_step(q[:, t:t + 1], k[:, t:t + 1], v[:, t:t + 1],
                                 li[:, t:t + 1], lf[:, t:t + 1], carry)
        outs.append(o[:, 0])
    _close(out_chunk, torch.stack(outs, 1), REC_TOL)
    # the final carries agree up to the stabilizer's common factor
    for a, bb in ((C, carry[0]), (n, carry[1])):
        scale = torch.exp(m - carry[2])
        _close(a * scale.reshape(*scale.shape, *([1] * (a.dim() - 2))), bb,
               REC_TOL)


@pytest.mark.parametrize("chunk", [16, 32, 64])
def test_mlstm_chunk_size_invariance(chunk):
    """tests/test_recurrent.py:39-50: the chunk size is an implementation
    detail, not semantics."""
    b, s, h, dh = 1, 64, 2, 8
    r = np.random.default_rng(1)
    q, k, v = (torch.from_numpy(r.normal(size=(b, s, h, dh)).astype(
        np.float32)) for _ in range(3))
    li = torch.from_numpy(r.normal(size=(b, s, h)).astype(np.float32))
    lf = torch.nn.functional.logsigmoid(torch.from_numpy(
        r.normal(size=(b, s, h)).astype(np.float32)))
    ref, _ = tx.mlstm_chunkwise(q, k, v, li, lf, chunk=s)
    out, _ = tx.mlstm_chunkwise(q, k, v, li, lf, chunk=chunk)
    _close(out, ref, REC_TOL)


# --------------------------------------------------------------- sLSTM -----
@pytest.mark.parametrize("s", [1, 40])
def test_slstm_block_matches_reference(cfgs, s):
    j_cfg, cfg = cfgs
    jp, tp = _params(jx.slstm_init, j_cfg, 6)
    x = _x((2, s, cfg.d_model), 7)
    want, _ = jx.slstm_block_apply(jp, j_cfg, jnp.asarray(x))
    got, cache = tx.slstm_block_apply(tp, cfg, torch.from_numpy(x))
    assert cache is None
    _close(got, want)


def test_slstm_scan_state_matches_reference(cfgs):
    """The final (c, n, h, m) of a 24-step scan from a carried state."""
    j_cfg, cfg = cfgs
    jp, tp = _params(jx.slstm_init, j_cfg, 8)
    x = _x((2, 24, cfg.d_model), 9)
    dh = cfg.d_model // cfg.xlstm.num_heads
    r = np.random.default_rng(10)
    st = [r.normal(size=(2, cfg.xlstm.num_heads, dh)).astype(np.float32)
          for _ in range(4)]
    st[1] = np.abs(st[1]) + 0.5                    # a positive normalizer
    want_h, want_st = jx.slstm_scan(jp, j_cfg, jnp.asarray(x),
                                    tuple(map(jnp.asarray, st)))
    got_h, got_st = tx.slstm_scan(tp, cfg, torch.from_numpy(x),
                                  tuple(map(torch.from_numpy, st)))
    _close(got_h, want_h)
    for name, a, b in zip("cnhm", got_st, want_st):
        _close(a, b, msg=name)


def test_slstm_decode_matches_reference_step_by_step(cfgs):
    j_cfg, cfg = cfgs
    jp, tp = _params(jx.slstm_init, j_cfg, 11)
    x = _x((2, 10, cfg.d_model), 12)
    jc = jx.init_slstm_cache(j_cfg, 2)
    tc = tx.init_slstm_cache(cfg, 2)
    for t in range(x.shape[1]):
        want, jc = jx.slstm_block_apply(jp, j_cfg, jnp.asarray(x[:, t:t + 1]),
                                        cache=jc, index=t)
        got, out = tx.slstm_block_apply(tp, cfg, torch.from_numpy(
            x[:, t:t + 1]), cache=tc, index=t)
        assert out is tc
        _close(got, want, msg=f"step {t}")
        for name, a, b in zip("cnhm", tc["state"], jc["state"]):
            _close(a, b, msg=f"step {t} state {name}")


# ------------------------------------------------------- decode vs full ----
@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_multi_token_decode_matches_full_forward(cfgs, kind):
    """Decoding 20 tokens one at a time through one cache gives the full
    forward's outputs at every position: a decode that lost its in-place
    cache writes would restart from a zero state at every token."""
    _, cfg = cfgs
    gen = torch.Generator().manual_seed(13)
    init = tx.mlstm_init if kind == "mlstm" else tx.slstm_init
    apply = (tx.mlstm_block_apply if kind == "mlstm"
             else tx.slstm_block_apply)
    make_cache = (tx.init_mlstm_cache if kind == "mlstm"
                  else tx.init_slstm_cache)
    p = init(gen, cfg)
    x = torch.from_numpy(_x((2, 20, cfg.d_model), 14))
    full, _ = apply(p, cfg, x)
    cache = make_cache(cfg, 2)
    steps = [apply(p, cfg, x[:, t:t + 1], cache=cache, index=t)[0]
             for t in range(x.shape[1])]
    _close(torch.cat(steps, 1), full, REC_TOL)


def test_decode_cache_is_constant_in_length():
    """tests/test_recurrent.py:84-95: xLSTM decode caches are O(1) in the
    sequence length, and float32 whatever dtype is asked for."""
    model = build_model(get_arch("xlstm-350m").reduced())

    def nbytes(max_len):
        c = model.init_cache(1, max_len, dtype=torch.bfloat16)
        leaves = [t for _, t in tree_leaves_with_path(c)]
        assert all(t.dtype == torch.float32 for t in leaves)
        return sum(t.numel() * t.element_size() for t in leaves)

    assert nbytes(1000) == nbytes(100000)


# ---------------------------------------------------- params and scales ----
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_convert_carries_xlstm_params(dtype):
    """The reference's xlstm-350m parameters at reduced(num_layers=6)
    (lead, scan and tail stages; the scan stage's block trees stacked),
    with the (K, di) conv and the (H, dh, 4dh) r, cross bit for bit."""
    j_cfg = j_get_arch("xlstm-350m").reduced(num_layers=6)
    jp = _np(j_build(j_cfg).init(jax.random.PRNGKey(0),
                                 dtype=getattr(jnp, dtype)))
    tp = params_from_numpy(jp, "cpu")
    back = params_to_numpy(tp)
    for (path, a), (_, b) in zip(tree_leaves_with_path(jp),
                                 tree_leaves_with_path(back)):
        assert a.shape == b.shape and a.dtype == b.dtype, path
        assert np.array_equal(a.view(np.uint8), b.view(np.uint8)), path
    di = int(j_cfg.d_model * j_cfg.xlstm.proj_factor_mlstm)
    h = j_cfg.xlstm.num_heads
    dh = j_cfg.d_model // h
    assert tuple(tp["stage0"]["b0"]["block"]["conv"].shape) == (4, di)
    assert tuple(tp["stage1"]["b0"]["block"]["r"].shape) == (2, h, dh,
                                                             4 * dh)
    assert tuple(tp["stage1"]["b1"]["block"]["conv"].shape) == (2, 4, di)
    assert tp["stage1"]["b1"]["block"]["i_gate"]["w"].dtype == torch.float32


@pytest.mark.parametrize("which", ["conv", "r"])
def test_init_scales_match_reference(which):
    """``truncated_normal`` draws the conv weight (K, di) at 1/sqrt(K) and
    the recurrent r (H, dh, 4dh) at 1/sqrt(dh), as the reference: the
    two generators' draws differ, their law does not (same bounds, same
    standard deviation within sampling error)."""
    cfg = get_arch("xlstm-350m")
    di = int(cfg.d_model * cfg.xlstm.proj_factor_mlstm)
    dh = cfg.d_model // cfg.xlstm.num_heads
    shape, scale = {"conv": ((4, di), 1 / math.sqrt(4)),
                    "r": ((4, dh, 4 * dh), 1 / math.sqrt(dh))}[which]
    ours = init_utils.truncated_normal(torch.Generator().manual_seed(0),
                                       shape, scale).numpy()
    from repro.models.init_utils import truncated_normal as j_tn
    ref = np.asarray(j_tn(jax.random.PRNGKey(0), shape, scale, jnp.float32))
    assert ours.shape == ref.shape == shape
    for a in (ours, ref):
        assert np.abs(a).max() <= 2 * scale * (1 + 1e-6)
    # a standard normal truncated to [-2, 2] has std 0.8796
    np.testing.assert_allclose(ours.std(), ref.std(), rtol=0.02)
    np.testing.assert_allclose(ours.std() / scale, 0.8796, rtol=0.02)
