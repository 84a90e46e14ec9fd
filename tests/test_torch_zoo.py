"""Port parity for the six decoder architectures of the MoE / MLA / M-RoPE
slice against the JAX package, each at ``reduced(num_layers=3)`` with the
reference's own ``init`` carried in.  Here: qwen2-vl-7b (qkv bias,
M-RoPE, the patch-embedding frontend), command-r-plus-104b (layernorm),
mistral-large-123b and gemma3-27b (sliding-window layers); the two MoE
architectures run the same checks in ``test_torch_zoo_moe.py``: olmoe-1b-7b
(MoE, widened to 8 experts, top-2) and deepseek-v2-236b (MLA, a first
dense layer, then MoE widened to 8 experts, top-3, with its shared
expert).

Per architecture: the stages and the parameter tree (keys, shapes,
dtypes), the loss with the MoE auxiliary term and its gradient, and a
decode loop; qwen2-vl with ``patch_embeds`` and ``positions3`` in the
loss and in the decode.  ``apply_mrope`` alone, and its reduction to RoPE
when the three position streams are equal (as
``tests/test_attention.py``'s ``test_mrope_reduces_to_rope_for_text``).

Tolerances (float32): 1e-4 on the loss, its gradient and the decode
logits, the transformer tests' own.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_arch as j_get_arch
from repro.models import build_model as j_build
from repro.models import layers as jl
from repro.models import transformer as jt
from repro_torch.configs.registry import get_arch
from repro_torch.convert import params_from_numpy
from repro_torch.models import layers as tl
from repro_torch.models import transformer as tt
from repro_torch.models.registry import build_model
from repro_torch.utils.tree import path_leaves, tree_leaves, tree_map

TOL = 1e-4
ARCHS = ("qwen2-vl-7b", "command-r-plus-104b", "mistral-large-123b",
         "gemma3-27b")
WIDENED = {"olmoe-1b-7b": dict(num_experts=8, top_k=2),
           "deepseek-v2-236b": dict(num_experts=8, top_k=3)}
LAYERS, BATCH, SEQ, STEPS = 3, 2, 32, 6


def zoo_config(get, arch):
    """``reduced(num_layers=3)``, the MoE widened past top_k = experts."""
    cfg = get(arch).reduced(num_layers=LAYERS)
    if arch in WIDENED:
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, **WIDENED[arch]))
    return cfg


def zoo_batch(cfg, seed=1):
    """numpy tokens and labels (B, S); for the VLM, patch embeddings
    (B, P, D) and M-RoPE positions (B, S, 3)."""
    r = np.random.default_rng(seed)
    toks = r.integers(0, cfg.vocab_size, (BATCH, SEQ)).astype(np.int32)
    batch = {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}
    if cfg.vlm is not None:
        batch["patch_embeds"] = (0.02 * r.normal(size=(
            BATCH, cfg.vlm.num_patch_tokens, cfg.d_model))).astype(
            np.float32)
        batch["positions3"] = r.integers(0, SEQ, (BATCH, SEQ, 3)).astype(
            np.int32)
    return batch


def zoo_setup(arch):
    """Both configs and models, the reference's parameters (PRNGKey(0))
    and the port's copy of them, and a batch."""
    j_cfg, cfg = zoo_config(j_get_arch, arch), zoo_config(get_arch, arch)
    jm, tm = j_build(j_cfg), build_model(cfg)
    jp = jax.jit(jm.init)(jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return arch, j_cfg, cfg, jm, tm, jp, tp, zoo_batch(cfg)


@pytest.fixture(scope="module", params=ARCHS)
def zoo(request):
    return zoo_setup(request.param)


def check_config_stages_and_param_tree(zoo):
    arch, j_cfg, cfg, _, tm, _, tp, _ = zoo
    assert dataclasses.asdict(get_arch(arch)) == dataclasses.asdict(
        j_get_arch(arch))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(j_cfg)
    assert ([(s.which, s.layer_ids, s.repeats) for s in tt.compute_stages(cfg)]
            == [(s.which, s.layer_ids, s.repeats)
                for s in jt.compute_stages(j_cfg)])
    ours = tm.init(torch.Generator().manual_seed(0))
    assert ({p: (tuple(t.shape), t.dtype) for p, t in path_leaves(ours)}
            == {p: (tuple(t.shape), t.dtype) for p, t in path_leaves(tp)})


def check_loss_and_gradient(zoo):
    """The model's loss (with router_aux_loss x aux for the MoE models)
    and its gradient in every leaf; the VLM with its frontend inputs."""
    arch, j_cfg, cfg, jm, tm, jp, tp, batch = zoo
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    want, want_g = jax.jit(jax.value_and_grad(jm.loss))(jp, jb)
    tree = tree_map(lambda t: t.clone().requires_grad_(), tp)
    got = tm.loss(tree, {k: torch.from_numpy(v) for k, v in batch.items()})
    grads = torch.autograd.grad(got, tree_leaves(tree))
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=TOL,
                               atol=TOL)
    want_g = dict(path_leaves(jax.tree.map(np.asarray, want_g)))
    for (path, _), g in zip(path_leaves(tree), grads):
        np.testing.assert_allclose(g.numpy(), want_g[path], rtol=TOL,
                                   atol=TOL, err_msg=path)
    _, aux = tm.apply(tp, {k: torch.from_numpy(v)
                           for k, v in batch.items()})
    _, j_aux = jm.apply(jp, jb)
    np.testing.assert_allclose(float(aux), float(j_aux), rtol=1e-6,
                               atol=1e-6)
    assert (float(aux) > 0) == (cfg.moe is not None)


def check_decode_loop(zoo):
    """STEPS one-token steps (the VLM's with their M-RoPE ids), logits at
    every step."""
    arch, j_cfg, cfg, jm, tm, jp, tp, batch = zoo
    jc = jm.init_cache(BATCH, STEPS, dtype=jnp.float32)
    tc = tm.init_cache(BATCH, STEPS, dtype=torch.float32)
    assert ({p: tuple(t.shape) for p, t in path_leaves(tc)}
            == {p: tuple(t.shape) for p, t in path_leaves(
                jax.tree.map(np.asarray, jc))})
    step = jax.jit(jm.decode_step)
    toks = batch["tokens"]
    for i in range(STEPS):
        kw, jkw = {}, {}
        if cfg.vlm is not None:
            p3 = batch["positions3"][:, i:i + 1]
            kw, jkw = ({"positions3": torch.from_numpy(p3)},
                       {"positions3": jnp.asarray(p3)})
        jlog, jc = step(jp, jnp.asarray(toks[:, i:i + 1]), jc,
                        jnp.asarray(i, jnp.int32), **jkw)
        tlog, tc = tm.decode_step(tp, torch.from_numpy(toks[:, i:i + 1]),
                                  tc, i, **kw)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=TOL,
                                   atol=TOL, err_msg=f"step {i}")


def test_config_stages_and_param_tree_match_reference(zoo):
    check_config_stages_and_param_tree(zoo)


def test_loss_and_gradient_match_reference(zoo):
    check_loss_and_gradient(zoo)


def test_decode_loop_matches_reference(zoo):
    check_decode_loop(zoo)


def test_vlm_frontend_inputs_reach_the_trunk():
    """qwen2-vl's hidden states move with its patch embeddings (over the
    first num_patch_tokens positions) and with positions3."""
    cfg = zoo_config(get_arch, "qwen2-vl-7b")
    tm = build_model(cfg)
    tp = tm.init(torch.Generator().manual_seed(0))
    batch = {k: torch.from_numpy(v) for k, v in zoo_batch(cfg).items()}
    base, _ = tm.apply(tp, batch)
    text, _ = tm.apply(tp, {"tokens": batch["tokens"]})
    no_patch = {k: v for k, v in batch.items() if k != "patch_embeds"}
    mrope, _ = tm.apply(tp, no_patch)
    assert not torch.allclose(base, mrope)
    assert not torch.allclose(mrope, text)
    x = tt.embed_tokens(tp, cfg, batch["tokens"], batch["patch_embeds"])
    n = cfg.vlm.num_patch_tokens
    assert torch.equal(x[:, :n], batch["patch_embeds"])
    assert torch.equal(x[:, n:], tt.embed_tokens(tp, cfg,
                                                 batch["tokens"])[:, n:])


@pytest.mark.parametrize("sections,head_dim", [((16, 24, 24), 128),
                                               ((8, 4, 4), 32)])
def test_apply_mrope_matches_reference(sections, head_dim):
    """Positions up to 2048 (qwen2-vl's training length): float32 cos and
    sin of angles of 2048 radians differ by ~1e-5 between XLA's and
    torch's range reduction, within TOL."""
    r = np.random.default_rng(4)
    x = r.normal(size=(2, 12, 3, head_dim)).astype(np.float32)
    pos3 = r.integers(0, 2048, (2, 12, 3)).astype(np.int32)
    want = jl.apply_mrope(jnp.asarray(x), jnp.asarray(pos3), 1e6, sections)
    got = tl.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos3), 1e6,
                         sections)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


def test_apply_mrope_reduces_to_rope_for_text():
    """Text tokens carry the same position in all three streams; M-RoPE
    then rotates exactly as RoPE (bit for bit)."""
    x = torch.from_numpy(np.random.default_rng(5).normal(
        size=(2, 10, 4, 32)).astype(np.float32))
    pos = torch.arange(10)[None].expand(2, 10)
    got = tl.apply_mrope(x, pos[..., None].expand(2, 10, 3), 1e4, (8, 4, 4))
    assert torch.equal(got, tl.apply_rope(x, pos, 1e4))
