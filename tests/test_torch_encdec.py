"""Port parity for the encoder-decoder, seamless-m4t-medium
(``repro_torch.models.encdec``, ``attention.cross_kv`` and
``attn_apply(kv_override=)``) against ``repro.models.encdec`` at
``reduced()`` (2 encoder and 2 decoder layers, d_model 256, 4 heads of
64, 32 source frames), on the reference's own parameters carried across
by ``convert.params_from_numpy``.

Here: the config and the parameter tree, ``encode``, ``apply`` and the
loss, every gradient, a 12-step greedy decode from ``encode`` +
``precompute_cross``, ``cross_kv`` and ``attn_apply(kv_override=)`` alone
(RoPE on q only), the frontend split and its ``ValueError``, the
full-width parameter count on the meta device, and the routing: K2 takes
the self-attention (one length for q and k), the dense path the
cross-attention, and K2's wrapper still refuses k and v of another length.

Tolerances (float32): 1e-5 on ``encode``, ``apply``, the loss and the
decode logits; 1e-4 on the gradients (the transformer tests' own).  The
decode's tokens must be equal.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_arch as j_get_arch
from repro.core.split import split_spec_for as j_split_spec_for
from repro.models import attention as ja
from repro.models import build_model as j_build
from repro.models import encdec as je
from repro_torch.configs.registry import get_arch
from repro_torch.convert import params_from_numpy
from repro_torch.core.split import count_parts, split_spec_for
from repro_torch.hopper.flash_attention import ops as fa_ops
from repro_torch.models import attention as ta
from repro_torch.models import encdec as te
from repro_torch.models.init_utils import shape_generator
from repro_torch.models.registry import build_model
from repro_torch.utils.tree import path_leaves, tree_leaves, tree_map

ARCH = "seamless-m4t-medium"
TOL = 1e-5
GRAD_TOL = 1e-4
BATCH, SEQ, STEPS, PROMPT = 2, 16, 12, 3


def _batch(cfg, seed=1):
    r = np.random.default_rng(seed)
    toks = r.integers(0, cfg.vocab_size, (BATCH, SEQ)).astype(np.int32)
    src = (0.02 * r.normal(size=(BATCH, cfg.encdec.max_source_len,
                                 cfg.d_model))).astype(np.float32)
    return {"tokens": toks, "labels": np.roll(toks, -1, axis=1),
            "source_embeds": src}


@pytest.fixture(scope="module")
def ed():
    """Both configs and models, the reference's parameters (PRNGKey(0)),
    the port's copy, a batch, and the reference's loss, gradient and
    encoder memory on it (shared by the tests)."""
    j_cfg, cfg = j_get_arch(ARCH).reduced(), get_arch(ARCH).reduced()
    jm, tm = j_build(j_cfg), build_model(cfg)
    jp = jax.jit(jm.init)(jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    batch = _batch(cfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    loss, grad = jax.jit(jax.value_and_grad(jm.loss))(jp, jb)
    memory = jax.jit(lambda p, s: je.encode(p, j_cfg, s))(
        jp, jb["source_embeds"])
    hidden, _ = jax.jit(jm.apply)(jp, jb)
    return dict(j_cfg=j_cfg, cfg=cfg, jm=jm, tm=tm, jp=jp, tp=tp,
                batch=batch, loss=float(loss),
                grad=dict(path_leaves(jax.tree.map(np.asarray, grad))),
                memory=np.array(memory), hidden=np.asarray(hidden))


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def test_config_and_param_tree_match_reference(ed):
    assert dataclasses.asdict(get_arch(ARCH)) == dataclasses.asdict(
        j_get_arch(ARCH))
    assert dataclasses.asdict(ed["cfg"]) == dataclasses.asdict(ed["j_cfg"])
    ours = ed["tm"].init(torch.Generator().manual_seed(0))
    assert ({p: (tuple(t.shape), t.dtype) for p, t in path_leaves(ours)}
            == {p: (tuple(t.shape), t.dtype)
                for p, t in path_leaves(ed["tp"])})
    assert set(ours) == {"src_proj", "encoder", "enc_norm", "embed",
                         "decoder", "final_norm", "lm_head"}


def test_encode_matches_reference(ed):
    got = te.encode(ed["tp"], ed["cfg"],
                    torch.from_numpy(ed["batch"]["source_embeds"]))
    np.testing.assert_allclose(got.numpy(), ed["memory"], rtol=TOL, atol=TOL)


def test_apply_and_loss_match_reference(ed):
    hidden, aux = ed["tm"].apply(ed["tp"], _t(ed["batch"]))
    np.testing.assert_allclose(hidden.numpy(), ed["hidden"], rtol=TOL,
                               atol=TOL)
    assert float(aux) == 0.0
    loss = ed["tm"].loss(ed["tp"], _t(ed["batch"]))
    np.testing.assert_allclose(float(loss), ed["loss"], rtol=TOL, atol=TOL)


def test_every_gradient_matches_reference(ed):
    tree = tree_map(lambda t: t.clone().requires_grad_(), ed["tp"])
    loss = ed["tm"].loss(tree, _t(ed["batch"]))
    grads = torch.autograd.grad(loss, tree_leaves(tree))
    paths = [p for p, _ in path_leaves(tree)]
    assert set(paths) == set(ed["grad"])
    for path, g in zip(paths, grads):
        np.testing.assert_allclose(g.numpy(), ed["grad"][path],
                                   rtol=GRAD_TOL, atol=GRAD_TOL,
                                   err_msg=path)


def test_twelve_step_decode_matches_reference(ed):
    """The cross cache from ``encode`` + ``precompute_cross`` over the
    batch's frames, PROMPT prompt tokens stepped in, then greedy tokens to
    STEPS steps in all: logits at every step, the same tokens."""
    j_cfg, cfg = ed["j_cfg"], ed["cfg"]
    src = ed["batch"]["source_embeds"]
    jc = je.init_cache(j_cfg, BATCH, STEPS, dtype=jnp.float32)
    jc["cross"] = je.precompute_cross(ed["jp"], j_cfg,
                                      jnp.asarray(ed["memory"]),
                                      dtype=jnp.float32)
    tc = te.init_cache(cfg, BATCH, STEPS, dtype=torch.float32)
    assert ({p: tuple(t.shape) for p, t in path_leaves(tc)}
            == {p: tuple(t.shape) for p, t in path_leaves(
                jax.tree.map(np.asarray, jc))})
    with torch.no_grad():
        tc["cross"] = te.precompute_cross(
            ed["tp"], cfg, te.encode(ed["tp"], cfg, torch.from_numpy(src)),
            dtype=torch.float32)
    np.testing.assert_allclose(tc["cross"]["k"].numpy(),
                               np.asarray(jc["cross"]["k"]), rtol=TOL,
                               atol=TOL)
    step = jax.jit(ed["jm"].decode_step)
    jtok = ttok = ed["batch"]["tokens"][:, :1]
    for i in range(STEPS):
        jl, jc = step(ed["jp"], jnp.asarray(jtok), jc, jnp.int32(i))
        with torch.no_grad():
            tl, tc = ed["tm"].decode_step(ed["tp"], torch.from_numpy(ttok),
                                          tc, i)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=TOL,
                                   atol=TOL, err_msg=f"step {i}")
        if i + 1 < PROMPT:
            jtok = ttok = ed["batch"]["tokens"][:, i + 1:i + 2]
        else:
            jtok = np.asarray(jl[..., :cfg.vocab_size].argmax(-1),
                              np.int32)
            ttok = tl[..., :cfg.vocab_size].argmax(-1).to(
                torch.int32).numpy()
            assert ttok.tolist() == jtok.tolist(), f"step {i}"


@pytest.mark.parametrize("rope_theta", [0.0, 10_000.0])
def test_cross_kv_and_kv_override_match_reference(ed, rope_theta):
    """Decoder layer 0's cross-attention alone on random queries and the
    memory: k and v from ``cross_kv``, then the sublayer; with a non-zero
    theta RoPE turns q and leaves the memory's keys as they are."""
    j_cfg, cfg = ed["j_cfg"], ed["cfg"]
    jpc = jax.tree.map(lambda a: a[0], ed["jp"]["decoder"]["cross"])
    tpc = tree_map(lambda a: a[0], ed["tp"]["decoder"]["cross"])
    mem = ed["memory"]
    jk, jv = ja.cross_kv(jpc, j_cfg, jnp.asarray(mem))
    tk, tv = ta.cross_kv(tpc, cfg, torch.from_numpy(mem))
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=TOL,
                               atol=TOL)
    h = np.random.default_rng(3).normal(
        size=(BATCH, SEQ, cfg.d_model)).astype(np.float32)
    want = ja.attn_apply(jpc, j_cfg, jnp.asarray(h), causal=False,
                         rope_theta=rope_theta, kv_override=(jk, jv))
    got = ta.attn_apply(tpc, cfg, torch.from_numpy(h), causal=False,
                        rope_theta=rope_theta, kv_override=(tk, tv))
    assert got.shape == (BATCH, SEQ, cfg.d_model)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


def test_k2_takes_self_attention_and_dense_the_cross(ed, monkeypatch):
    """One K2 call per encoder and per decoder self-attention layer, each
    with k and v of q's length; the cross-attention goes to the dense path
    (32 frames under 16 tokens); the wrapper refuses k, v of another
    length than q."""
    seen, dense_seen = [], []
    flash, dense = ta.flash_attention, ta.dense_attention

    def counted(q, k, v, **kw):
        seen.append((q.shape[1], k.shape[1], kw["causal"]))
        return flash(q, k, v, **kw)

    def counted_dense(q, k, v, **kw):
        dense_seen.append((q.shape[1], k.shape[1]))
        return dense(q, k, v, **kw)

    monkeypatch.setattr(ta, "flash_attention", counted)
    monkeypatch.setattr(ta, "dense_attention", counted_dense)
    with torch.no_grad():
        ed["tm"].apply(ed["tp"], _t(ed["batch"]))
    cfg = ed["cfg"]
    src = cfg.encdec.max_source_len
    assert seen == ([(src, src, False)] * cfg.encdec.num_encoder_layers
                    + [(SEQ, SEQ, True)] * cfg.num_layers)
    assert dense_seen == [(SEQ, src)] * cfg.num_layers
    q = torch.zeros(1, SEQ, 4, 64)
    kv = torch.zeros(1, src, 4, 64)
    with pytest.raises(ValueError, match="do not match"):
        fa_ops.flash_attention(q, kv, kv, causal=False)


def test_frontend_split_and_its_value_error(ed):
    cfg, j_cfg = get_arch(ARCH), j_get_arch(ARCH)
    spec, j_spec = split_spec_for(cfg), j_split_spec_for(j_cfg)
    assert spec.client_patterns == j_spec.client_patterns
    assert spec.head_patterns == j_spec.head_patterns
    parts = {p: spec.part_of(p) for p, _ in path_leaves(ed["tp"])}
    assert parts == {p: j_spec.part_of(p) for p in parts}
    assert {p.split("/")[0] for p, part in parts.items()
            if part == "client"} == {"src_proj", "embed"}
    assert {p for p, part in parts.items() if part == "head"} == {
        "lm_head/w"}
    assert split_spec_for(cfg, cut=cfg.n_client_layers) == spec
    for cut in (0, 1, 3):
        with pytest.raises(ValueError, match="frontend-based split"):
            split_spec_for(cfg, cut=cut)
        with pytest.raises(ValueError, match="frontend-based split"):
            j_split_spec_for(j_cfg, cut=cut)


def test_full_width_parameter_count_matches_reference():
    """seamless-m4t-medium whole on the meta device: every leaf's shape
    and the client / body / head counts, exact against the reference's
    ``eval_shape``; about 0.98 B parameters."""
    cfg, j_cfg = get_arch(ARCH), j_get_arch(ARCH)
    ours = build_model(cfg).init(shape_generator())
    shapes = jax.eval_shape(j_build(j_cfg).init, jax.random.PRNGKey(0))
    want = {p: (tuple(s.shape), str(s.dtype))
            for p, s in path_leaves(shapes)}
    got = {p: (tuple(t.shape), str(t.dtype).replace("torch.", ""))
           for p, t in path_leaves(ours)}
    assert got == want
    counts = count_parts(ours, split_spec_for(cfg))
    total = sum(math.prod(s) for s, _ in want.values())
    assert sum(counts.values()) == total
    assert counts["head"] == cfg.d_model * cfg.padded_vocab
    assert 0.97e9 < total < 0.99e9, total


def test_serve_matches_reference_main(capsys):
    """``--arch seamless-m4t-medium``: the reference's serving main at small
    flags (the reduced config; the bank's batches carry source frames, and
    ``encode`` + ``precompute_cross`` fill the decode cache's cross half)
    against ``serve()`` with its parameters: the same profiles and
    tokens."""
    import json

    from repro.launch import serve as j_serve
    from repro_torch.launch import serve as t_serve
    flags = dict(batch=3, steps=6, clients=2, prompt_len=5, seed=0)
    jp = j_build(j_get_arch(ARCH).reduced()).init(jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    j_serve.main([f"--{k.replace('_', '-')}={v}" for k, v in flags.items()]
                 + [f"--arch={ARCH}"])
    ref = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    res = t_serve.serve(get_arch(ARCH).reduced(), params=tp, device="cpu",
                        **flags)
    assert res.profiles.tolist() == ref["profiles"]
    assert res.generated.tolist() == ref["generated"]
    assert torch.isfinite(res.logits).all()
