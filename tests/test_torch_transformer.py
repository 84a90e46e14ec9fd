"""Port parity for ``models/transformer.py`` and ``models/registry.py`` at
``gemma3-12b.reduced(num_layers=12)``: lead, scan and tail stages, five
sliding-window layers (window 64) to each global one, qk-norm, gelu and
the embedding scale, with the reference's own ``init`` carried in; at
``xlstm-350m.reduced(num_layers=6)``: the mLSTM and sLSTM layer kinds in
all three stages, with their recurrent decode caches; and at
``recurrentgemma-2b.reduced(num_layers=8)``: RG-LRU and local-attention
layers (one kv head) in all three stages, each with its MLP.

Tolerances (float32): 1e-4 on the hidden states and logits after twelve
layers (summation order compounds through the residual stream), 1e-5 on
the loss and 1e-4 on its gradient.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_arch as j_get_arch
from repro.models import build_model as j_build
from repro.models import transformer as jt
from repro_torch.configs.registry import get_arch
from repro_torch.convert import params_from_numpy
from repro_torch.hopper.flash_attention import kernel
from repro_torch.models.registry import build_model
from repro_torch.models import transformer as tt
from repro_torch.utils.tree import tree_leaves_with_path

TOL = 1e-4


@pytest.fixture(scope="module")
def setup():
    j_cfg = j_get_arch("gemma3-12b").reduced(num_layers=12)
    cfg = get_arch("gemma3-12b").reduced(num_layers=12)
    jm, tm = j_build(j_cfg), build_model(cfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    toks = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 80)).astype(np.int32)
    return j_cfg, cfg, jm, tm, jp, tp, toks


def test_stages_and_param_tree_match_reference(setup):
    j_cfg, cfg, jm, tm, jp, tp, _ = setup
    assert ([(s.which, s.layer_ids, s.repeats) for s in tt.compute_stages(cfg)]
            == [(s.which, s.layer_ids, s.repeats)
                for s in jt.compute_stages(j_cfg)])
    assert [s.which for s in tt.compute_stages(cfg)] == ["lead", "scan",
                                                         "tail"]
    ours = tm.init(torch.Generator().manual_seed(0))
    shapes = {p: (tuple(t.shape), t.dtype)
              for p, t in tree_leaves_with_path(ours)}
    want = {p: (tuple(t.shape), t.dtype)
            for p, t in tree_leaves_with_path(tp)}
    assert shapes == want


def test_apply_matches_reference(setup):
    j_cfg, cfg, jm, tm, jp, tp, toks = setup
    want, _ = jm.apply(jp, {"tokens": jnp.asarray(toks)})
    before = kernel.launches
    got, aux = tm.apply(tp, {"tokens": torch.from_numpy(toks)})
    assert kernel.launches == before and float(aux) == 0.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    dense, _ = tm.apply(tp, {"tokens": torch.from_numpy(toks)},
                        impl="dense")
    np.testing.assert_allclose(got.numpy(), dense.numpy(), rtol=TOL,
                               atol=TOL)


def test_lm_loss_and_head_gradient_match_reference(setup):
    """A 1024-token sequence: two 512-token loss chunks."""
    j_cfg, cfg, jm, tm, jp, tp, _ = setup
    r = np.random.default_rng(2)
    hidden = r.normal(size=(2, 1024, cfg.d_model)).astype(np.float32)
    labels = r.integers(0, cfg.vocab_size, (2, 1024)).astype(np.int32)

    def j_loss(w):
        return jt.lm_loss({"lm_head": {"w": w}}, j_cfg, jnp.asarray(hidden),
                          jnp.asarray(labels))

    want, want_g = jax.value_and_grad(j_loss)(jp["lm_head"]["w"])
    w = tp["lm_head"]["w"].clone().requires_grad_()
    got = tt.lm_loss({"lm_head": {"w": w}}, cfg, torch.from_numpy(hidden),
                     torch.from_numpy(labels))
    (g,) = torch.autograd.grad(got, [w])
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    np.testing.assert_allclose(g.numpy(), np.asarray(want_g), rtol=TOL,
                               atol=1e-7)


def test_model_loss_and_prefill(setup):
    j_cfg, cfg, jm, tm, jp, tp, toks = setup
    labels = np.roll(toks, -1, axis=1)
    want = jm.loss(jp, {"tokens": jnp.asarray(toks),
                        "labels": jnp.asarray(labels)})
    got = tm.loss(tp, {"tokens": torch.from_numpy(toks),
                       "labels": torch.from_numpy(labels)})
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    jl, jh = jt.prefill(jp, j_cfg, {"tokens": jnp.asarray(toks)})
    tl, th = tt.prefill(tp, cfg, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=TOL,
                               atol=TOL)


def test_decode_loop_matches_reference(setup):
    """70 one-token steps (past the window of 64, so the local layers'
    rings wrap), logits at every step, and the hidden-state form."""
    j_cfg, cfg, jm, tm, jp, tp, toks = setup
    steps = 70
    jc = jm.init_cache(2, steps, dtype=jnp.float32)
    tc = tm.init_cache(2, steps, dtype=torch.float32)
    assert ({p: tuple(t.shape) for p, t in tree_leaves_with_path(tc)}
            == {p: tuple(t.shape) for p, t in tree_leaves_with_path(
                jax.tree.map(np.asarray, jc))})
    step = jax.jit(jm.decode_step)
    for i in range(steps):
        tok = toks[:, i:i + 1]
        jl, jc = step(jp, jnp.asarray(tok), jc, jnp.asarray(i, jnp.int32))
        tl, tc = tm.decode_step(tp, torch.from_numpy(tok), tc, i)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=TOL,
                                   atol=TOL, err_msg=f"step {i}")
    jh, _ = jm.decode_step(jp, jnp.asarray(toks[:, :1]), jc,
                           jnp.asarray(steps - 1, jnp.int32),
                           return_hidden=True)
    th, _ = tm.decode_step(tp, torch.from_numpy(toks[:, :1]), tc, steps - 1,
                           return_hidden=True)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=TOL,
                               atol=TOL)


def test_embed_scale_rounds_to_the_dtype_first():
    """In bfloat16 at d_model 3840 the scale is 62.0, as the reference
    casts sqrt(3840) = 61.97 to x's dtype before the product."""
    cfg = dataclasses.replace(get_arch("gemma3-12b").reduced(),
                              d_model=3840, dtype="bfloat16")
    table = torch.ones(4, 3840, dtype=torch.bfloat16)
    x = tt.embed_tokens({"embed": {"table": table}}, cfg,
                        torch.tensor([[1, 2]]))
    assert x.dtype == torch.bfloat16 and float(x[0, 0, 0]) == 62.0
    jx = jt.embed_tokens({"embed": {"table": jnp.ones((4, 3840),
                                                      jnp.bfloat16)}},
                         j_get_arch("gemma3-12b"), jnp.asarray([[1, 2]]))
    assert float(jx[0, 0, 0]) == 62.0


# ---------------------------------------------------------- xlstm-350m -----
# reduced(num_layers=6): lead (layer 0, mLSTM), scan (layers 1-2, sLSTM
# then mLSTM, two repeats: stacked parameters and stacked caches) and tail
# (layer 5, sLSTM); xLSTM layers are {"ln1", "block"}, with no MLP
@pytest.fixture(scope="module")
def xsetup():
    j_cfg = j_get_arch("xlstm-350m").reduced(num_layers=6)
    cfg = get_arch("xlstm-350m").reduced(num_layers=6)
    jm, tm = j_build(j_cfg), build_model(cfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    toks = np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, 80)).astype(np.int32)
    return j_cfg, cfg, jm, tm, jp, tp, toks


@pytest.mark.parametrize("num_layers", [2, 6])
def test_xlstm_init_matches_reference_param_tree(num_layers):
    """``tt.init`` of xlstm-350m's reduced config runs and gives the
    reference's parameter tree: the same keys, shapes and dtypes."""
    j_cfg = j_get_arch("xlstm-350m").reduced(num_layers=num_layers)
    cfg = get_arch("xlstm-350m").reduced(num_layers=num_layers)
    ours = tt.init(torch.Generator().manual_seed(0), cfg)
    want = jax.eval_shape(lambda: j_build(j_cfg).init(
        jax.random.PRNGKey(0)))
    assert ({p: (tuple(t.shape), str(t.dtype).split(".")[-1])
             for p, t in tree_leaves_with_path(ours)}
            == {jax.tree_util.keystr(p): (tuple(t.shape), str(t.dtype))
                for p, t in jax.tree_util.tree_leaves_with_path(want)})
    assert ([(s.which, s.layer_ids, s.repeats) for s in tt.compute_stages(cfg)]
            == [(s.which, s.layer_ids, s.repeats)
                for s in jt.compute_stages(j_cfg)])


def test_xlstm_apply_matches_reference(xsetup):
    """The full forward over 80 tokens (one quadratic mLSTM chunk), with
    impl "auto" (K3's plain version on a CPU tensor) and "dense" (the
    model's own chunkwise form); no kernel launches on the CPU."""
    j_cfg, cfg, jm, tm, jp, tp, toks = xsetup
    assert [s.which for s in tt.compute_stages(cfg)] == ["lead", "scan",
                                                         "tail"]
    want, _ = jm.apply(jp, {"tokens": jnp.asarray(toks)})
    from repro_torch.hopper.mlstm_chunk import kernel as k3
    before = k3.launches
    got, aux = tm.apply(tp, {"tokens": torch.from_numpy(toks)})
    assert k3.launches == before and float(aux) == 0.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    plain, _ = tm.apply(tp, {"tokens": torch.from_numpy(toks)},
                        impl="dense")
    np.testing.assert_allclose(plain.numpy(), got.numpy(), rtol=TOL,
                               atol=TOL)
    labels = np.roll(toks, -1, axis=1)
    np.testing.assert_allclose(
        float(tm.loss(tp, {"tokens": torch.from_numpy(toks),
                           "labels": torch.from_numpy(labels)})),
        float(jm.loss(jp, {"tokens": jnp.asarray(toks),
                           "labels": jnp.asarray(labels)})), rtol=1e-5)


def test_xlstm_decode_loop_matches_reference(xsetup):
    """24 one-token steps through every stage kind; the recurrent caches
    (float32, stacked in the scan stage) are written in place and agree
    with the reference's returned caches; logits at every step."""
    j_cfg, cfg, jm, tm, jp, tp, toks = xsetup
    steps = 24
    jc = jm.init_cache(2, steps, dtype=jnp.float32)
    tc = tm.init_cache(2, steps, dtype=torch.float32)
    shapes = {p: tuple(t.shape) for p, t in tree_leaves_with_path(tc)}
    assert shapes == {p: tuple(t.shape) for p, t in tree_leaves_with_path(
        jax.tree.map(np.asarray, jc))}
    assert shapes["['stage1']['b1']['carry'][0]"] == (2, 2, 2, 256, 256)
    step = jax.jit(jm.decode_step)
    for i in range(steps):
        tok = toks[:, i:i + 1]
        jl, jc = step(jp, jnp.asarray(tok), jc, jnp.asarray(i, jnp.int32))
        tl, tc2 = tm.decode_step(tp, torch.from_numpy(tok), tc, i)
        assert tc2 is tc
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=TOL,
                                   atol=TOL, err_msg=f"step {i}")
    want = dict(tree_leaves_with_path(jax.tree.map(np.asarray, jc)))
    for path, t in tree_leaves_with_path(tc):
        np.testing.assert_allclose(t.numpy(), want[path], rtol=TOL,
                                   atol=TOL, err_msg=path)
    jh, _ = jm.decode_step(jp, jnp.asarray(toks[:, :1]), jc,
                           jnp.asarray(steps, jnp.int32), return_hidden=True)
    th, _ = tm.decode_step(tp, torch.from_numpy(toks[:, :1]), tc, steps,
                           return_hidden=True)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=TOL,
                               atol=TOL)


# --------------------------------------------------- recurrentgemma-2b -----
# reduced(num_layers=8): lead (layer 0, RG-LRU), scan (layers 1-3: RG-LRU,
# local attention, RG-LRU, two repeats: stacked parameters and stacked
# caches) and tail (layer 7, RG-LRU); window 64, one kv head
@pytest.fixture(scope="module")
def rsetup():
    j_cfg = j_get_arch("recurrentgemma-2b").reduced(num_layers=8)
    cfg = get_arch("recurrentgemma-2b").reduced(num_layers=8)
    jm, tm = j_build(j_cfg), build_model(cfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    toks = np.random.default_rng(4).integers(
        0, cfg.vocab_size, (2, 80)).astype(np.int32)
    return j_cfg, cfg, jm, tm, jp, tp, toks


def test_recurrentgemma_stages_and_param_tree_match_reference(rsetup):
    j_cfg, cfg, jm, tm, jp, tp, _ = rsetup
    stages = [(s.which, s.layer_ids, s.repeats)
              for s in tt.compute_stages(cfg)]
    assert stages == [(s.which, s.layer_ids, s.repeats)
                      for s in jt.compute_stages(j_cfg)]
    assert stages == [("lead", (0,), 1), ("scan", (1, 2, 3), 2),
                      ("tail", (7,), 1)]
    assert [cfg.layer_kinds()[i] for i in (1, 2, 3)] == [
        "rglru", "local_attn", "rglru"]
    ours = tm.init(torch.Generator().manual_seed(0))
    assert ({p: (tuple(t.shape), t.dtype)
             for p, t in tree_leaves_with_path(ours)}
            == {p: (tuple(t.shape), t.dtype)
                for p, t in tree_leaves_with_path(tp)})
    full = get_arch("recurrentgemma-2b")
    assert [(s.which, s.layer_ids, s.repeats)
            for s in tt.compute_stages(full)] == [("lead", (0, 1), 1),
                                                  ("scan", (2, 3, 4), 8)]


def test_recurrentgemma_apply_matches_reference(rsetup):
    """The full forward over 80 tokens (past the window of 64), with impl
    "auto" (K4's and K2's plain versions on a CPU tensor) and "dense";
    no kernel launches on the CPU; the loss and the prefill logits."""
    j_cfg, cfg, jm, tm, jp, tp, toks = rsetup
    want, _ = jm.apply(jp, {"tokens": jnp.asarray(toks)})
    from repro_torch.hopper.rglru_scan import kernel as k4
    before = (k4.launches, kernel.launches)
    got, aux = tm.apply(tp, {"tokens": torch.from_numpy(toks)})
    assert (k4.launches, kernel.launches) == before and float(aux) == 0.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    dense, _ = tm.apply(tp, {"tokens": torch.from_numpy(toks)},
                        impl="dense")
    np.testing.assert_allclose(dense.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    labels = np.roll(toks, -1, axis=1)
    np.testing.assert_allclose(
        float(tm.loss(tp, {"tokens": torch.from_numpy(toks),
                           "labels": torch.from_numpy(labels)})),
        float(jm.loss(jp, {"tokens": jnp.asarray(toks),
                           "labels": jnp.asarray(labels)})), rtol=1e-5)
    jl, _ = jt.prefill(jp, j_cfg, {"tokens": jnp.asarray(toks)})
    tl, _ = tt.prefill(tp, cfg, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=TOL,
                               atol=TOL)


def test_recurrentgemma_decode_loop_matches_reference(rsetup):
    """70 one-token steps through every stage kind (past the window of 64,
    so the local layers' rings wrap); the RG-LRU caches (float32, stacked
    in the scan stage) are written in place and agree with the
    reference's returned caches; logits at every step."""
    j_cfg, cfg, jm, tm, jp, tp, toks = rsetup
    steps = 70
    jc = jm.init_cache(2, steps, dtype=jnp.float32)
    tc = tm.init_cache(2, steps, dtype=torch.float32)
    shapes = {p: tuple(t.shape) for p, t in tree_leaves_with_path(tc)}
    assert shapes == {p: tuple(t.shape) for p, t in tree_leaves_with_path(
        jax.tree.map(np.asarray, jc))}
    assert shapes["['stage1']['b0']['h']"] == (2, 2, 256)
    assert shapes["['stage1']['b1']['k']"] == (2, 2, 64, 1, 64)
    step = jax.jit(jm.decode_step)
    for i in range(steps):
        tok = toks[:, i:i + 1]
        jl, jc = step(jp, jnp.asarray(tok), jc, jnp.asarray(i, jnp.int32))
        tl, tc2 = tm.decode_step(tp, torch.from_numpy(tok), tc, i)
        assert tc2 is tc
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=TOL,
                                   atol=TOL, err_msg=f"step {i}")
    want = dict(tree_leaves_with_path(jax.tree.map(np.asarray, jc)))
    for path, t in tree_leaves_with_path(tc):
        np.testing.assert_allclose(t.numpy(), want[path].astype(np.float32),
                                   rtol=TOL, atol=TOL, err_msg=path)
    jh, _ = jm.decode_step(jp, jnp.asarray(toks[:, :1]), jc,
                           jnp.asarray(steps, jnp.int32), return_hidden=True)
    th, _ = tm.decode_step(tp, torch.from_numpy(toks[:, :1]), tc, steps,
                           return_hidden=True)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=TOL,
                               atol=TOL)
