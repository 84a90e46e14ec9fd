"""Port parity for ``repro_torch.optim`` against ``repro.optim``: every
optimizer and schedule on the same numpy inputs, float32 and bfloat16
parameters, three steps.

Exact equality where the IEEE operations match one for one: SGD's
``-lr * g`` (a Python learning rate takes the gradient's dtype on both
sides) and ``apply_updates`` (float32 add, one cast back).  rtol 1e-6
elsewhere: momentum, AdamW (``b ** count``, sqrt and division in
float32), the schedules' cosines, the global norm's sum.
"""

import ml_dtypes
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro import optim as jopt
from repro_torch import optim as topt
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.utils.tree import path_leaves

DTYPES = {"float32": np.float32, "bfloat16": ml_dtypes.bfloat16}
SHAPES = {"w": (5, 7), "b": (7,), "head": {"w": (7, 3)}}
MASK = {"w": True, "b": True, "head": {"w": False}}


def _tree(rng, dtype, scale=1.0):
    def mk(shape):
        return (scale * rng.standard_normal(shape)).astype(dtype)
    return {"w": mk(SHAPES["w"]), "b": mk(SHAPES["b"]),
            "head": {"w": mk(SHAPES["head"]["w"])}}


def _jax(tree):
    if isinstance(tree, dict):
        return {k: _jax(v) for k, v in tree.items()}
    return jnp.asarray(tree)


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    return np.asarray(tree)


def _flat(tree):
    """path -> float64 numpy of a jax or torch tree."""
    if any(isinstance(v, torch.Tensor) for _, v in path_leaves(tree)):
        tree = params_to_numpy(tree)
    return {p: np.asarray(v).astype(np.float64)
            for p, v in path_leaves(_np(tree))}


def _dtypes(tree):
    if any(isinstance(v, torch.Tensor) for _, v in path_leaves(tree)):
        tree = params_to_numpy(tree)
    return {p: np.asarray(v).dtype.name for p, v in path_leaves(_np(tree))}


def _same(got, want, exact):
    g, w = _flat(got), _flat(want)
    assert g.keys() == w.keys()
    assert _dtypes(got) == _dtypes(want)
    for p in g:
        if exact:
            np.testing.assert_array_equal(g[p], w[p], err_msg=p)
        else:
            np.testing.assert_allclose(g[p], w[p], rtol=1e-6, atol=0,
                                       err_msg=p)


def _run(make, dtype, steps=3, seed=0, mask=None):
    """Both sides' (updates, state, params) after ``steps`` updates."""
    rng = np.random.default_rng(seed)
    p_np = _tree(rng, DTYPES[dtype])
    grads = [_tree(rng, DTYPES[dtype], 0.5) for _ in range(steps)]
    jo, to = make(jopt), make(topt)
    if mask is not None:
        jo, to = jopt.masked(jo, mask), topt.masked(to, mask)
    jp, tp = _jax(p_np), params_from_numpy(p_np, "cpu")
    js, ts = jo.init(jp), to.init(tp)
    for g in grads:
        ju, js = jo.update(_jax(g), js, jp)
        tu, ts = to.update(params_from_numpy(g, "cpu"), ts, tp)
        jp, tp = jopt.apply_updates(jp, ju), topt.apply_updates(tp, tu)
    return (tu, ts, tp), (ju, js, jp)


OPTIMIZERS = {
    "sgd": lambda m: m.sgd(0.05),
    "sgd_schedule": lambda m: m.sgd(m.cosine_decay(0.05, 4)),
    "momentum": lambda m: m.momentum(0.05, 0.9),
    "momentum_nesterov": lambda m: m.momentum(0.05, 0.9, nesterov=True),
    "momentum_schedule": lambda m: m.momentum(m.warmup_cosine(0.05, 1, 4)),
    "adamw": lambda m: m.adamw(1e-2),
    "adamw_wd": lambda m: m.adamw(1e-2, weight_decay=0.1),
    "adamw_schedule": lambda m: m.adamw(m.constant(1e-2)),
    "make_sgd": lambda m: m.make_optimizer("sgd", 0.05),
    "make_momentum": lambda m: m.make_optimizer("momentum", 0.05),
    "make_adamw": lambda m: m.make_optimizer("adamw", 1e-2,
                                             weight_decay=0.01),
}
EXACT = {"sgd", "make_sgd"}


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_matches_reference(name, dtype):
    got, want = _run(OPTIMIZERS[name], dtype)
    for g, w in zip(got, want):
        _same(g, w, exact=name in EXACT)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("name", ["sgd", "momentum", "adamw"])
def test_masked_matches_reference_and_freezes(name, dtype):
    (tu, ts, tp), want = _run(OPTIMIZERS[name], dtype, mask=MASK)
    for g, w in zip((tu, ts, tp), want):
        _same(g, w, exact=name == "sgd")
    # the frozen leaf never moves and keeps its inner state (the
    # reference's keys); its moments stay zero
    rng = np.random.default_rng(0)
    p0 = params_from_numpy(_tree(rng, DTYPES[dtype]), "cpu")
    assert torch.equal(tp["head"]["w"], p0["head"]["w"])
    assert not torch.equal(tp["w"], p0["w"])
    assert (tu["head"]["w"] == 0).all()
    for key in ("mu", "m", "v"):
        if key in ts:
            assert set(ts[key]) == {"w", "b", "head"}
            assert (ts[key]["head"]["w"] == 0).all()


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("name", ["sgd", "momentum", "adamw"])
def test_masked_apply_updates_returns_frozen_leaf(name, dtype):
    """``apply_updates`` with the mask returns a frozen leaf itself (no
    float32 round trip) and the trainable ones as without it; the frozen
    update is a broadcast zero, with no buffer of the leaf's size."""
    rng = np.random.default_rng(5)
    p = params_from_numpy(_tree(rng, DTYPES[dtype]), "cpu")
    g = params_from_numpy(_tree(rng, DTYPES[dtype], 0.5), "cpu")
    opt = topt.masked(OPTIMIZERS[name](topt), MASK)
    u, _ = opt.update(g, opt.init(p), p)
    assert u["head"]["w"].stride() == (0, 0)
    assert (u["head"]["w"] == 0).all()
    got = topt.apply_updates(p, u, MASK)
    want = topt.apply_updates(p, u)
    assert got["head"]["w"] is p["head"]["w"]
    _same(got, want, exact=True)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_sgd_update_keeps_gradient_dtype(dtype):
    """SGD's update stays in the gradient's dtype (bf16 at full width);
    with a schedule the float32 learning rate promotes it, as in JAX."""
    (tu, _, tp), (ju, _, jp) = _run(OPTIMIZERS["sgd"], dtype, steps=1)
    assert tu["w"].dtype == getattr(torch, dtype)
    assert _dtypes(tu) == _dtypes(ju)
    (tu, _, _), (ju, _, _) = _run(OPTIMIZERS["sgd_schedule"], dtype,
                                  steps=1)
    assert tu["w"].dtype == torch.float32
    assert _dtypes(tu) == _dtypes(ju)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_apply_updates_exact(dtype):
    """float32 add, cast back to the parameter's dtype: bit-equal."""
    rng = np.random.default_rng(3)
    p = _tree(rng, DTYPES[dtype])
    u = _tree(rng, np.float32, 1e-2)
    got = topt.apply_updates(params_from_numpy(p, "cpu"),
                             params_from_numpy(u, "cpu"))
    want = jopt.apply_updates(_jax(p), _jax(u))
    _same(got, want, exact=True)


@pytest.mark.parametrize("max_norm", [0.1, 1e3])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_global_norm_and_clip(dtype, max_norm):
    rng = np.random.default_rng(4)
    g = _tree(rng, DTYPES[dtype])
    tg, jg = params_from_numpy(g, "cpu"), _jax(g)
    np.testing.assert_allclose(float(topt.global_norm(tg)),
                               float(jopt.global_norm(jg)), rtol=1e-6)
    _same(topt.clip_by_global_norm(tg, max_norm),
          jopt.clip_by_global_norm(jg, max_norm), exact=False)


SCHEDULES = {
    "constant": lambda m: m.constant(0.03),
    "cosine": lambda m: m.cosine_decay(0.1, 7),
    "cosine_alpha": lambda m: m.cosine_decay(0.1, 7, alpha=0.2),
    "warmup_cosine": lambda m: m.warmup_cosine(0.1, 3, 10),
    "warmup_cosine_alpha": lambda m: m.warmup_cosine(0.1, 3, 10, alpha=0.1),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedule_matches_reference(name):
    ts, js = SCHEDULES[name](topt), SCHEDULES[name](jopt)
    for count in range(14):
        got = ts(torch.tensor(count, dtype=torch.int32))
        want = js(jnp.asarray(count, jnp.int32))
        assert got.dtype == torch.float32 and got.shape == ()
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6,
                                   err_msg=f"count {count}")


def test_unknown_optimizer_raises():
    with pytest.raises(ValueError):
        topt.make_optimizer("lion", 0.1)
