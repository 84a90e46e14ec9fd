"""Port parity for ``models/rglru.py``: the RG-LRU recurrent block at
``recurrentgemma-2b.reduced()`` (d_model = lru_width = 256, conv 4)
against ``repro.models.rglru`` on the same numpy inputs, with the
reference's own parameters carried in; the decode step against the
reference's, cache by cache; and a multi-token decode against the full
forward, which shows the in-place cache writes take effect.

Tolerances: 1e-4 in float32 on the block outputs (three projections and
two gate products summed in another order, then a recurrence over up to
80 steps) and 1e-5 on the gates; in bfloat16, where every projection's
output is rounded to bfloat16 on both sides, 2e-2 (a few bfloat16 steps
of 2^-8 at the outputs' magnitude of about one).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_arch as j_get_arch
from repro.models import build_model as j_build
from repro.models import rglru as jr
from repro_torch.configs.registry import get_arch
from repro_torch.convert import params_from_numpy
from repro_torch.hopper.rglru_scan import kernel
from repro_torch.hopper.rglru_scan.ref import rglru_scan_ref
from repro_torch.models import rglru as tr
from repro_torch.models.registry import build_model
from repro_torch.utils.tree import tree_leaves_with_path

TOL = {"float32": 1e-4, "bfloat16": 2e-2}


@pytest.fixture(scope="module")
def cfgs():
    return (j_get_arch("recurrentgemma-2b").reduced(),
            get_arch("recurrentgemma-2b").reduced())


def _params(j_cfg, seed, dtype="float32"):
    jp = jr.rglru_init(jax.random.PRNGKey(seed), j_cfg,
                       dtype=getattr(jnp, dtype))
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def _x(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _close(got, want, tol=TOL["float32"], msg=""):
    got = got.detach().to(torch.float32).numpy() if isinstance(
        got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=tol,
                               atol=tol, err_msg=msg)


@pytest.mark.parametrize("s", [1, 32, 80])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_block_matches_reference(cfgs, s, dtype):
    """The full-sequence block with impl "auto" (K4's plain sequential
    version on a CPU tensor) and "dense" (the parallel form) against the
    reference's (``rglru_scan_assoc``), weights and input in ``dtype``."""
    j_cfg, cfg = cfgs
    jp, tp = _params(j_cfg, 0, dtype)
    x = _x((2, s, cfg.d_model), s)
    jx_ = jnp.asarray(x).astype(dtype)
    tx_ = torch.from_numpy(x).to(getattr(torch, dtype))
    want, _ = jr.rglru_block_apply(jp, j_cfg, jx_)
    before = kernel.launches
    got, cache = tr.rglru_block_apply(tp, cfg, tx_)
    assert cache is None and kernel.launches == before
    assert got.dtype == tx_.dtype and got.shape == tx_.shape
    _close(got, want, TOL[dtype])
    dense, _ = tr.rglru_block_apply(tp, cfg, tx_, impl="dense")
    _close(dense, want, TOL[dtype])


def test_block_sends_the_recurrence_through_the_kernel_wrapper(
        cfgs, monkeypatch):
    """impl "auto" calls ``ops.rglru_scan`` once, with float32 log_a and b
    (B,S,W) and a zero float32 h0 (B,W); "dense" does not call it."""
    j_cfg, cfg = cfgs
    _, tp = _params(j_cfg, 1)
    calls = []

    def spy(log_a, b, h0):
        calls.append((log_a.shape, log_a.dtype, b.dtype, h0.clone()))
        return rglru_scan_ref(log_a, b, h0)

    monkeypatch.setattr(tr, "rglru_scan", spy)
    x = torch.from_numpy(_x((3, 16, cfg.d_model), 2))
    tr.rglru_block_apply(tp, cfg, x)
    tr.rglru_block_apply(tp, cfg, x, impl="dense")
    assert len(calls) == 1
    shape, la_dt, b_dt, h0 = calls[0]
    assert shape == (3, 16, cfg.rglru.lru_width)
    assert la_dt == b_dt == h0.dtype == torch.float32
    assert h0.shape == (3, cfg.rglru.lru_width) and not h0.any()
    with pytest.raises(ValueError, match="impl"):
        tr.rglru_block_apply(tp, cfg, x, impl="flash")


def test_gates_match_reference_with_large_lambda(cfgs):
    """log_a and b of the recurrence, with Lambda pushed past 20 in some
    channels: ``jax.nn.softplus`` is logaddexp(x, 0) at every x, where
    ``F.softplus`` would switch to x itself (b's sqrt(1 - a^2) floor of
    1e-9 is met where a rounds to 1)."""
    j_cfg, cfg = cfgs
    jp, tp = _params(j_cfg, 2)
    w = cfg.rglru.lru_width
    lam = np.asarray(jp["lam"]).copy()
    lam[:8] = np.linspace(15.0, 40.0, 8)
    lam[8:16] = np.linspace(-40.0, -30.0, 8)    # a rounds to 1: the floor
    jp = {**jp, "lam": jnp.asarray(lam)}
    tp = {**tp, "lam": torch.from_numpy(lam)}
    u = _x((2, 24, w), 3)
    want = jr._gates(jp, jnp.asarray(u))
    got = tr._gates(tp, torch.from_numpy(u))
    for name, a, b in zip(("log_a", "b"), got, want):
        assert a.dtype == torch.float32, name
        _close(a, b, 1e-5, name)


def test_decode_matches_reference_step_by_step(cfgs):
    """Twelve one-token steps through the block with its cache, on both
    sides: the port writes its cache in place and returns the same
    object; the reference returns a new one.  Both caches agree after
    every step."""
    j_cfg, cfg = cfgs
    jp, tp = _params(j_cfg, 4)
    x = _x((2, 12, cfg.d_model), 5)
    jc = jr.init_rglru_cache(j_cfg, 2)
    tc = tr.init_rglru_cache(cfg, 2)
    ids = {id(t) for _, t in tree_leaves_with_path(tc)}
    step = jax.jit(lambda p, x_, c, i: jr.rglru_block_apply(
        p, j_cfg, x_, cache=c, index=i))
    for t in range(x.shape[1]):
        want, jc = step(jp, jnp.asarray(x[:, t:t + 1]), jc, t)
        got, out = tr.rglru_block_apply(tp, cfg, torch.from_numpy(
            x[:, t:t + 1]), cache=tc, index=t)
        assert out is tc
        _close(got, want, msg=f"step {t}")
        for name in ("conv", "h"):
            assert tc[name].dtype == torch.float32
            _close(tc[name], jc[name], msg=f"step {t} cache {name}")
    assert {id(t) for _, t in tree_leaves_with_path(tc)} == ids


def test_multi_token_decode_matches_full_forward(cfgs):
    """Decoding 20 tokens one at a time through one cache gives the full
    forward's outputs at every position: a decode that lost its in-place
    cache writes would restart from a zero state at every token."""
    _, cfg = cfgs
    p = tr.rglru_init(torch.Generator().manual_seed(13), cfg)
    x = torch.from_numpy(_x((2, 20, cfg.d_model), 14))
    full, _ = tr.rglru_block_apply(p, cfg, x)
    cache = tr.init_rglru_cache(cfg, 2)
    steps = [tr.rglru_block_apply(p, cfg, x[:, t:t + 1], cache=cache,
                                  index=t)[0] for t in range(x.shape[1])]
    _close(torch.cat(steps, 1), full.detach())
    # the carried state is the full forward's last one
    log_a, b = tr._gates(p, tr.causal_conv1d(x @ p["in_x"]["w"],
                                             p["conv"])[0])
    h_full = rglru_scan_ref(log_a, b, torch.zeros(2, cfg.d_model))
    _close(cache["h"], h_full[:, -1])


def test_decode_cache_is_constant_in_length():
    """tests/test_recurrent.py:84-95 for recurrentgemma: the RG-LRU caches
    are O(1) in the sequence length and float32 whatever dtype is asked
    for, and the local-attention layers keep a window-sized ring."""
    cfg = get_arch("recurrentgemma-2b").reduced(num_layers=8)
    model = build_model(cfg)

    def nbytes(max_len):
        c = model.init_cache(1, max_len, dtype=torch.bfloat16)
        leaves = dict(tree_leaves_with_path(c))
        assert leaves["['stage0']['b0']['h']"].dtype == torch.float32
        assert leaves["['stage1']['b0']['conv']"].shape == (2, 1, 3, 256)
        return sum(t.numel() * t.element_size() for t in leaves.values())

    assert nbytes(1000) == nbytes(100000)


@pytest.mark.parametrize("num_layers", [2, 8])
def test_init_matches_reference_param_tree(num_layers):
    """``transformer.init`` of recurrentgemma-2b's reduced config gives the
    reference's parameter tree: the same keys, shapes and dtypes (the
    gate biases and Lambda float32 in every dtype)."""
    j_cfg = j_get_arch("recurrentgemma-2b").reduced(num_layers=num_layers)
    cfg = get_arch("recurrentgemma-2b").reduced(num_layers=num_layers)
    ours = build_model(cfg).init(torch.Generator().manual_seed(0),
                                 dtype=torch.bfloat16)
    want = jax.eval_shape(lambda: j_build(j_cfg).init(
        jax.random.PRNGKey(0), dtype=jnp.bfloat16))
    assert ({p: (tuple(t.shape), str(t.dtype).split(".")[-1])
             for p, t in tree_leaves_with_path(ours)}
            == {jax.tree_util.keystr(p): (tuple(t.shape), str(t.dtype))
                for p, t in jax.tree_util.tree_leaves_with_path(want)})


def test_lambda_init_law_matches_reference():
    """Lambda = softplus^-1(-log(u) / 8) with u uniform on (0.9, 0.999):
    a^c = exp(-8 softplus(Lambda)) lies in that interval on both sides;
    the two generators' draws differ, their law does not."""
    cfg = get_arch("recurrentgemma-2b")
    ours = tr.rglru_init(torch.Generator().manual_seed(0),
                         cfg.reduced(d_model=2048))["lam"]
    ref = jr.rglru_init(jax.random.PRNGKey(0),
                        j_get_arch("recurrentgemma-2b").reduced(
                            d_model=2048))["lam"]
    for lam in (ours.numpy(), np.asarray(ref)):
        a_c = np.exp(-8.0 * np.logaddexp(lam, 0.0))
        assert lam.dtype == np.float32 and lam.shape == (2048,)
        assert a_c.min() > 0.9 - 1e-6 and a_c.max() < 0.999 + 1e-6
        np.testing.assert_allclose(a_c.mean(), (0.9 + 0.999) / 2, atol=0.005)
    assert not np.array_equal(ours.numpy(), np.asarray(ref))
    scale = tr.rglru_init(torch.Generator().manual_seed(1), cfg.reduced())
    w = cfg.reduced().rglru.lru_width
    assert float(scale["w_a"]["w"].abs().max()) <= 2 / math.sqrt(w) + 1e-6
