"""Port parity for the one-device PHSFL round (``repro_torch.core.phsfl``)
against the reference's ``repro.core.phsfl.make_host_round``, on the
reference's own setup (``tests/test_host_round.py``: xlstm-350m reduced,
C = 4 clients, kappa0 = 2 local steps of micro-batch 2, 32 tokens), with
the reference's parameters and optimizer states carried in.  The
reference side is its participation round throughout: with an all-ones
mask it is its unmasked round bit for bit (its own test), so one compile
serves both.

Tolerance: the reference's own, rtol 2e-5 / atol 2e-6
(``tests/test_host_round.py:78-79``), on parameters, optimizer states
and the loss.  Exact where the reference is exact: the frozen head stays
at its initial value bit for bit, every client holds the same model after
the edge step, a full participation mask gives the unmasked round bit for
bit, an empty ES keeps its previous models.  Also ``extract_head`` /
``merge_head`` and the masked host aggregations.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import HierarchyConfig as JH
from repro.configs.base import TrainConfig as JT
from repro.configs.registry import get_arch as j_get_arch
from repro.core import build_optimizer as j_build_optimizer
from repro.core import hierarchy as jhier
from repro.core import init_stacked_params as j_init_stacked
from repro.core import make_host_round as j_make_host_round
from repro.core import personalize as jpers
from repro.data.synthetic import synthetic_token_batch
from repro.models import build_model as j_build
from repro.utils.tree import map_with_path as j_map_with_path
from repro_torch.configs.base import HierarchyConfig, TrainConfig
from repro_torch.configs.registry import get_arch
from repro_torch.convert import params_from_numpy
from repro_torch.core import hierarchy as thier
from repro_torch.core import personalize as tpers
from repro_torch.core.phsfl import (build_optimizer, init_stacked_params,
                                    make_host_round)
from repro_torch.models.registry import build_model
from repro_torch.utils.prng import make_generator
from repro_torch.utils.tree import path_leaves, tree_leaves

C, K, MICRO, SEQ = 4, 2, 2, 32
TOL = dict(rtol=2e-5, atol=2e-6)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's side on one intra-op thread.  The tier-1 run puts six
    test processes on eight cores; torch's default of a thread a core
    then spends most of a small op waiting on the others (and starves the
    reference's side), which made this file one of the slowest.  The
    tolerances and assertions are the same at any thread count."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flat_j(tree):
    out = {}
    j_map_with_path(lambda p, x: out.setdefault(p, np.asarray(x)), tree)
    return out


def _flat_t(tree):
    return {p: t.detach().numpy() for p, t in path_leaves(tree)}


def _close(got, want, **tol):
    g, w = _flat_t(got), _flat_j(want)
    assert g.keys() == w.keys()
    for p in g:
        assert g[p].dtype == w[p].dtype, p
        np.testing.assert_allclose(g[p], w[p], **(tol or TOL), err_msg=p)


def _to_port(tree):
    return params_from_numpy(jax.tree.map(np.asarray, tree), "cpu")


def _setup(arch, c=C, k=K, layers=None):
    """The reference's fixture (test_host_round.py:33-50) for ``arch``:
    stacked params from PRNGKey(0), broadcast optimizer states, one
    synthetic batch (C, K, MICRO, SEQ), uniform alpha_u."""
    kw = {} if layers is None else {"num_layers": layers}
    j_cfg = j_get_arch(arch).reduced(**kw)
    jm = j_build(j_cfg)
    jt = JT(learning_rate=0.05, freeze_head=True, remat=False)
    jp = j_init_stacked(jm, jax.random.PRNGKey(0), c)
    jopt, _ = j_build_optimizer(jm, jt)
    s1 = jopt.init(jax.tree.map(lambda x: x[0], jp))
    js = jax.tree.map(lambda x: jnp.broadcast_to(x[None], (c,) + x.shape),
                      s1)
    nb = synthetic_token_batch(0, c * k * MICRO, SEQ, j_cfg.vocab_size)
    batch = {n: v.reshape(c, k, MICRO, SEQ) for n, v in nb.items()}
    return dict(j_cfg=j_cfg, jm=jm, jt=jt, jp=jp, js=js, batch=batch,
                cfg=get_arch(arch).reduced(**kw),
                t=TrainConfig(learning_rate=0.05, freeze_head=True,
                              remat=False),
                tp=_to_port(jp), ts=_to_port(js), c=c, k=k)


@pytest.fixture(scope="module")
def xl():
    return _setup("xlstm-350m")


def _rounds(s, b=1, global_sync=False, participation=False):
    """The port's round, and the reference's participation round, jitted
    once per (B, global_sync) and kept in ``s``: an all-ones mask gives
    the reference's unmasked round bit for bit (its own
    ``test_host_round_full_mask_bit_identical``), so one compile serves
    both the masked and the unmasked comparisons."""
    c = s["c"]
    key = ("jround", b, global_sync)
    if key not in s:
        jh = JH(num_edge_servers=b, clients_per_es=c // b, kappa0=s["k"],
                kappa1=1)
        s[key] = jax.jit(j_make_host_round(
            s["jm"], jh, s["jt"], num_clients=c, global_sync=global_sync,
            participation=True).fn)
    th = HierarchyConfig(num_edge_servers=b, clients_per_es=c // b,
                         kappa0=s["k"], kappa1=1)
    tr = make_host_round(build_model(s["cfg"]), th, s["t"], num_clients=c,
                         global_sync=global_sync,
                         participation=participation)
    return s[key], tr.fn


def _weights(c, b):
    au = np.full((c,), b / c, np.float32)
    ab = np.full((c,), 1.0 / b, np.float32)
    return au, ab


def _run_both(s, b=1, global_sync=False, mask=None):
    jfn, tfn = _rounds(s, b, global_sync, participation=mask is not None)
    au, ab = _weights(s["c"], b)
    jb = {n: jnp.asarray(v) for n, v in s["batch"].items()}
    tb = {n: torch.from_numpy(v) for n, v in s["batch"].items()}
    jmask = np.ones(s["c"], np.float32) if mask is None else mask
    jargs = [s["jp"], s["js"], jb, jnp.asarray(au), jnp.asarray(ab),
             jnp.asarray(jmask, jnp.float32)]
    targs = [s["tp"], s["ts"], tb, torch.from_numpy(au),
             torch.from_numpy(ab)]
    if mask is not None:
        targs.append(torch.tensor(mask, dtype=torch.float32))
    return tfn(*targs), jfn(*jargs)


@pytest.fixture(scope="module")
def xl_unmasked(xl):
    return _run_both(xl)


def test_host_round_matches_reference(xl, xl_unmasked):
    (tp, ts, tm), (jp, js, jm) = xl_unmasked
    _close(tp, jp)
    _close(ts, js)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), **TOL)
    assert np.isfinite(float(tm["loss"]))


def test_head_frozen_and_clients_synced(xl, xl_unmasked):
    (tp, ts, _), _ = xl_unmasked
    assert torch.equal(tp["lm_head"]["w"], xl["tp"]["lm_head"]["w"])
    for x in tree_leaves(tp):
        for i in range(1, C):
            assert torch.equal(x[0], x[i])
    assert ts["count"].tolist() == [K] * C
    # the body moved
    assert not torch.equal(tp["final_norm"]["scale"],
                           xl["tp"]["final_norm"]["scale"])


def test_full_mask_bit_identical(xl, xl_unmasked):
    """An all-ones participation mask reproduces the unmasked round bit
    for bit (the ideal network's trajectory)."""
    (tp, ts, tm), _ = xl_unmasked
    _, tfn = _rounds(xl, participation=True)
    au, ab = _weights(C, 1)
    tb = {n: torch.from_numpy(v) for n, v in xl["batch"].items()}
    mp, ms, mm = tfn(xl["tp"], xl["ts"], tb, torch.from_numpy(au),
                     torch.from_numpy(ab), torch.ones(C))
    for a, b in zip(tree_leaves(tp) + tree_leaves(ts),
                    tree_leaves(mp) + tree_leaves(ms)):
        assert torch.equal(a, b)
    assert torch.equal(tm["loss"], mm["loss"])


def test_partial_mask_matches_reference(xl):
    (tp, ts, tm), (jp, js, jm) = _run_both(xl, mask=[1.0, 0.0, 1.0, 0.0])
    _close(tp, jp)
    _close(ts, js)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), **TOL)
    assert torch.equal(tp["lm_head"]["w"], xl["tp"]["lm_head"]["w"])


def test_empty_es_keeps_previous_model(xl):
    _, tfn = _rounds(xl, participation=True)
    au, ab = _weights(C, 1)
    tb = {n: torch.from_numpy(v) for n, v in xl["batch"].items()}
    p, _, _ = tfn(xl["tp"], xl["ts"], tb, torch.from_numpy(au),
                  torch.from_numpy(ab), torch.zeros(C))
    for a, b in zip(tree_leaves(p), tree_leaves(xl["tp"])):
        assert torch.equal(a, b)


@pytest.mark.parametrize("mask", [None, [1.0, 0.0, 0.0, 0.0],
                                  [0.0, 1.0, 1.0, 1.0]],
                         ids=["unmasked", "es1-empty", "es0-half"])
def test_two_edge_servers_with_global_sync(xl, mask):
    """B = 2 ESs of two clients, global_sync: the global step of Eq. 16
    (over the ESs that had a participant when masked)."""
    (tp, ts, tm), (jp, js, jm) = _run_both(xl, b=2, global_sync=True,
                                           mask=mask)
    _close(tp, jp)
    _close(ts, js)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), **TOL)
    for x in tree_leaves(tp):
        for i in range(1, C):
            assert torch.equal(x[0], x[i])


@pytest.mark.parametrize("arch", ["gemma3-12b", "recurrentgemma-2b"])
def test_one_round_on_other_archs(arch):
    s = _setup(arch, c=2, k=1)
    (tp, ts, tm), (jp, js, jm) = _run_both(s)
    _close(tp, jp)
    _close(ts, js)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), **TOL)
    assert torch.equal(tp["lm_head"]["w"], s["tp"]["lm_head"]["w"])


def test_build_optimizer_mask_and_state_keys(xl):
    model = build_model(xl["cfg"])
    params = model.init(make_generator(0))
    opt, mask = build_optimizer(model, xl["t"], params=params)
    _, jmask = j_build_optimizer(xl["jm"], xl["jt"])
    jm = {}
    j_map_with_path(lambda p, m: jm.setdefault(p, m), jmask)
    assert dict(path_leaves(mask)) == jm
    assert set(opt.init(params)) == {"count"}
    stacked = init_stacked_params(model, make_generator(0), 3)
    for p, x in path_leaves(stacked):
        assert x.shape[0] == 3 and torch.equal(x[0], x[2]), p


def test_round_builds_its_optimizer_once(monkeypatch):
    """A round builds its optimizer and mask on its first call and reuses
    them: a second call equals a fresh round's call on the same inputs,
    bit for bit.  On gemma3-12b reduced, 2 clients of one step: the
    build-once logic is the same for every arch, and xlstm's sLSTM loop
    made this test's three rounds the slowest of the file."""
    from repro_torch.core import phsfl
    s = _setup("gemma3-12b", c=2, k=1)
    calls = []
    orig = phsfl.build_optimizer
    monkeypatch.setattr(phsfl, "build_optimizer",
                        lambda *a, **kw: calls.append(1) or orig(*a, **kw))
    au, ab = (torch.from_numpy(w) for w in _weights(s["c"], 1))
    tb = {n: torch.from_numpy(v) for n, v in s["batch"].items()}
    th = HierarchyConfig(num_edge_servers=1, clients_per_es=s["c"],
                         kappa0=s["k"], kappa1=1)
    make = lambda: make_host_round(build_model(s["cfg"]), th, s["t"],
                                   num_clients=s["c"], global_sync=False).fn
    reused = make()
    p1, s1, _ = reused(s["tp"], s["ts"], tb, au, ab)
    got, _, _ = reused(p1, s1, tb, au, ab)
    want, _, _ = make()(p1, s1, tb, au, ab)
    assert len(calls) == 2                   # one per round object
    for (path, a), (_, b) in zip(path_leaves(got), path_leaves(want)):
        assert torch.equal(a, b), path


# ------------------------------------------------- head graft, aggregation --
def test_extract_and_merge_head_match_reference(xl):
    jp = jax.tree.map(lambda x: x[0], xl["jp"])
    tp = _to_port(jp)
    th = tpers.extract_head(tp, xl["cfg"])
    jh = jpers.extract_head(jp, xl["j_cfg"])
    assert set(th) == set(jh) == {"lm_head"}
    _close(th, jh, rtol=0, atol=0)
    new = np.asarray(jh["lm_head"]["w"]) + 1.0
    tm = tpers.merge_head(tp, {"lm_head": {"w": torch.from_numpy(new)}},
                          xl["cfg"])
    jmg = jpers.merge_head(jp, {"lm_head": {"w": jnp.asarray(new)}},
                           xl["j_cfg"])
    _close(tm, jmg, rtol=0, atol=0)
    # a full params-shaped tree works as the head source too
    full = tpers.merge_head(tp, tm, xl["cfg"])
    assert torch.equal(full["lm_head"]["w"], tm["lm_head"]["w"])
    with pytest.raises(KeyError):
        tpers.merge_head(tp, {"other": {}}, xl["cfg"])


def _trees(n, seed=0):
    rng = np.random.default_rng(seed)
    return [{"a": rng.standard_normal((3, 4)).astype(np.float32),
             "b": {"c": rng.standard_normal(5).astype(np.float32)}}
            for _ in range(n)]


@pytest.mark.parametrize("mask", [[1, 1, 1], [1, 0, 1], [0, 0, 1]],
                         ids=["full", "partial", "one"])
@pytest.mark.parametrize("which", ["edge", "global"])
def test_masked_aggregations_match_reference(which, mask):
    trees = _trees(3)
    w = np.array([0.5, 0.3, 0.2])
    tfn = getattr(thier, f"masked_{which}_aggregate")
    jfn = getattr(jhier, f"masked_{which}_aggregate")
    got = tfn([params_from_numpy(t, "cpu") for t in trees], w, mask)
    want = jfn([jax.tree.map(jnp.asarray, t) for t in trees], w, mask)
    _close(got, want, rtol=1e-6, atol=1e-7)
    if all(mask):
        plain = getattr(thier, f"{which}_aggregate")(
            [params_from_numpy(t, "cpu") for t in trees], w)
        for a, b in zip(tree_leaves(got), tree_leaves(plain)):
            assert torch.equal(a, b)        # the unmasked path, bit for bit


def test_masked_aggregation_empty_mask():
    trees = [params_from_numpy(t, "cpu") for t in _trees(2)]
    fallback = params_from_numpy(_trees(1, seed=5)[0], "cpu")
    got = thier.masked_edge_aggregate(trees, [0.5, 0.5], [0, 0], fallback)
    assert got is fallback
    with pytest.raises(ValueError):
        thier.masked_global_aggregate(trees, [0.5, 0.5], [0, 0])
