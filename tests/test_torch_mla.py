"""Port parity for Multi-head Latent Attention (``repro_torch.models.mla``)
against the reference's ``repro.models.mla``, with the reference's
parameters carried in.

Two head geometries: deepseek-v2-236b's ``reduced()`` (q/k heads of 64 +
16 = 80 columns, v of 64) and one at the published head widths (128 + 64
= 192 columns, v of 128) with two heads.  The expanded form goes through
K2's wrapper, whose CPU path is its plain version, with v zero-padded to
the q/k width; the reference's ``"auto"`` at these lengths is its dense
path, which takes the narrower v as it is.  The absorbed decode runs
several steps against the reference's ``mla_decode_attend``, and the two
forms agree on one prefix.

Tolerances (float32): 1e-5 on a layer's output, 1e-4 on its gradients and
on the expanded-against-absorbed comparison (different summation orders
over the latent and the expanded heads).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import MLAConfig as JMLAConfig
from repro.configs.registry import get_arch as j_get_arch
from repro.models import mla as jmla
from repro_torch.configs.base import MLAConfig
from repro_torch.configs.registry import get_arch
from repro_torch.convert import params_from_numpy
from repro_torch.hopper.flash_attention import ops
from repro_torch.models import mla as tmla
from repro_torch.utils.tree import path_leaves, tree_leaves, tree_map

TOL, GRAD_TOL = 1e-5, 1e-4
PUBLISHED_HEADS = dict(q_lora_rank=64, kv_lora_rank=32, qk_nope_head_dim=128,
                       qk_rope_head_dim=64, v_head_dim=128)


@pytest.fixture(scope="module", params=["reduced", "published_heads"])
def setup(request):
    j_cfg = j_get_arch("deepseek-v2-236b").reduced()
    cfg = get_arch("deepseek-v2-236b").reduced()
    if request.param == "published_heads":
        j_cfg = dataclasses.replace(j_cfg, num_heads=2,
                                    mla=JMLAConfig(**PUBLISHED_HEADS))
        cfg = dataclasses.replace(cfg, num_heads=2,
                                  mla=MLAConfig(**PUBLISHED_HEADS))
    jp = jmla.mla_init(jax.random.PRNGKey(1), j_cfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    x = np.random.default_rng(2).normal(
        size=(2, 40, cfg.d_model)).astype(np.float32)
    return j_cfg, cfg, jp, tp, x


def test_param_tree_matches_reference(setup):
    j_cfg, cfg, _, tp, _ = setup
    assert dataclasses.asdict(cfg) == dataclasses.asdict(j_cfg)
    ours = tmla.mla_init(torch.Generator().manual_seed(0), cfg)
    assert ({p: (tuple(t.shape), t.dtype) for p, t in path_leaves(ours)}
            == {p: (tuple(t.shape), t.dtype) for p, t in path_leaves(tp)})


def test_expanded_form_through_k2_with_padded_v(setup, monkeypatch):
    """One K2 call a layer, with v padded to q/k's width."""
    j_cfg, cfg, jp, tp, x = setup
    m = cfg.mla
    seen = []
    real = ops._forward

    def spy(q, k, v, *a):
        seen.append((tuple(q.shape), tuple(k.shape), tuple(v.shape)))
        return real(q, k, v, *a)

    monkeypatch.setattr(ops, "_forward", spy)
    want = jmla.mla_apply(jp, j_cfg, jnp.asarray(x))
    got = tmla.mla_apply(tp, cfg, torch.from_numpy(x))
    d = m.qk_nope_head_dim + m.qk_rope_head_dim
    assert seen == [((2, 40, cfg.num_heads, d),) * 3]
    assert d > m.v_head_dim
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    dense = tmla.mla_apply(tp, cfg, torch.from_numpy(x), impl="dense")
    np.testing.assert_allclose(dense.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


def test_expanded_form_gradients_match_reference(setup):
    j_cfg, cfg, jp, tp, x = setup
    w = np.random.default_rng(3).normal(size=x.shape).astype(np.float32)

    def j_obj(p, xx):
        return (jmla.mla_apply(p, j_cfg, xx) * jnp.asarray(w)).sum()

    jg_p, jg_x = jax.grad(j_obj, argnums=(0, 1))(jp, jnp.asarray(x))
    tree = tree_map(lambda t: t.clone().requires_grad_(), tp)
    xt = torch.from_numpy(x).requires_grad_()
    obj = (tmla.mla_apply(tree, cfg, xt) * torch.from_numpy(w)).sum()
    grads = torch.autograd.grad(obj, [xt, *tree_leaves(tree)])
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(jg_x),
                               rtol=GRAD_TOL, atol=GRAD_TOL)
    want = dict(path_leaves(jax.tree.map(np.asarray, jg_p)))
    for (path, _), g in zip(path_leaves(tree), grads[1:]):
        np.testing.assert_allclose(g.numpy(), want[path], rtol=GRAD_TOL,
                                   atol=GRAD_TOL, err_msg=path)


def test_absorbed_decode_matches_reference(setup):
    """Twelve one-token steps into a cache of 12, in float32 as the
    reference: the outputs and the latent cache at every step."""
    j_cfg, cfg, jp, tp, x = setup
    steps = 12
    jc = jmla.init_mla_cache(j_cfg, 2, steps, jnp.float32)
    tc = tmla.init_mla_cache(cfg, 2, steps, torch.float32)
    assert {k: tuple(v.shape) for k, v in tc.items()} == {
        k: tuple(v.shape) for k, v in jc.items()}
    step = jax.jit(lambda p, xx, c, i: jmla.mla_decode_attend(
        p, j_cfg, xx, c, i))
    for i in range(steps):
        xi = x[:, i:i + 1]
        jo, jc = step(jp, jnp.asarray(xi), jc, jnp.asarray(i, jnp.int32))
        to, tc = tmla.mla_decode_attend(tp, cfg, torch.from_numpy(xi), tc,
                                        i)
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=TOL,
                                   atol=TOL, err_msg=f"step {i}")
    for k in ("c_kv", "k_rope"):
        np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]),
                                   rtol=TOL, atol=TOL, err_msg=k)


def test_expanded_and_absorbed_forms_agree_on_a_prefix(setup):
    """The expanded form over 16 tokens, and the absorbed form stepping
    through the same 16: the same causal attention, so the same outputs
    at every position."""
    _, cfg, _, tp, x = setup
    s = 16
    full = tmla.mla_apply(tp, cfg, torch.from_numpy(x[:, :s]))
    cache = tmla.init_mla_cache(cfg, 2, s, torch.float32)
    for i in range(s):
        out, cache = tmla.mla_decode_attend(
            tp, cfg, torch.from_numpy(x[:, i:i + 1]), cache, i)
        np.testing.assert_allclose(out.numpy(), full[:, i:i + 1].numpy(),
                                   rtol=GRAD_TOL, atol=GRAD_TOL,
                                   err_msg=f"position {i}")


def test_latent_cache_is_smaller_than_an_expanded_one():
    """At deepseek's published width the latent cache holds kv_lora +
    rope = 576 values a token and layer, against 2 x 128 heads x (192 or
    128) for expanded k and v."""
    cfg = get_arch("deepseek-v2-236b")
    c = tmla.init_mla_cache(cfg, 1, 1, torch.float32, device="meta")
    per_token = sum(t.numel() for t in c.values())
    m = cfg.mla
    expanded = cfg.num_heads * (m.qk_nope_head_dim + m.qk_rope_head_dim
                                + m.v_head_dim)
    assert per_token == 576 and expanded == 40960
