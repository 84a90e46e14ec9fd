"""Port parity for LM training and the head bank on the MoE and VLM
architectures: one round of ``make_host_round`` against the reference's
host round, in-process as ``test_torch_host_round.py`` runs it, and the
head bank (Eq. 18) with both evaluations against the reference's
``personalize_head_bank`` / ``personalized_eval``.

olmoe-1b-7b at ``reduced()`` with its MoE widened to 8 experts, top-2
(so the loss carries the router's auxiliary term and the sort, grouped
matmuls and combine run under autograd); qwen2-vl-7b at ``reduced()``
with the launcher's frontend inputs, built by the reference's formula
(``repro.launch.train._client_round_batch``: patch embeddings of 0.02,
M-RoPE positions the token index in all three streams), so that they
reach the trunk in the local steps and in the head bank.  The reference
maps MoE clients one at a time in the head bank (``lax.map``); the port's
one batched trunk pass is the same arithmetic per token.

Tolerances: the reference host round's own, rtol 2e-5 / atol 2e-6
(``tests/test_host_round.py:78-79``), and the serving tests' 1e-5 on the
head bank and the evaluations.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import TrainConfig as JT
from repro.configs.registry import get_arch as j_get_arch
from repro.core import build_optimizer as j_build_optimizer
from repro.core import init_stacked_params as j_init_stacked
from repro.core.personalize import personalize_head_bank as j_bank
from repro.core.personalize import personalized_eval as j_eval
from repro.data.synthetic import synthetic_token_batch
from repro.models import build_model as j_build
from repro_torch.configs.base import TrainConfig
from repro_torch.configs.registry import get_arch
from repro_torch.core.personalize import (personalize_head_bank,
                                          personalized_eval)
from repro_torch.launch import train as ttrain
from repro_torch.models.registry import build_model
from test_torch_host_round import TOL, _close, _run_both, _to_port

C, K, MICRO, SEQ = 2, 1, 2, 32
WIDENED = {"olmoe-1b-7b": dict(num_experts=8, top_k=2)}


def _cfg(get, arch):
    cfg = get(arch).reduced()
    if arch in WIDENED:
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, **WIDENED[arch]))
    return cfg


def reference_batch(cfg, c, k, micro, seq, seed):
    """The reference launcher's ``_client_round_batch`` (rebuilt here: its
    module imports ``repro.wireless``, which fails on this jax, R1),
    frontend inputs included, as numpy."""
    toks, labs = [], []
    for i in range(c):
        nb = synthetic_token_batch(seed * 1000 + i, k * micro, seq,
                                   max(cfg.vocab_size // 2, 2))
        shift = (i * cfg.vocab_size) // (2 * max(c, 1))
        toks.append((nb["tokens"] + shift) % cfg.vocab_size)
        labs.append((nb["labels"] + shift) % cfg.vocab_size)
    batch = {"tokens": np.stack(toks).reshape(c, k, micro, seq),
             "labels": np.stack(labs).reshape(c, k, micro, seq)}
    if cfg.vlm is not None:
        batch["patch_embeds"] = 0.02 * np.ones(
            (c, k, micro, cfg.vlm.num_patch_tokens, cfg.d_model), np.float32)
        batch["positions3"] = np.tile(
            np.arange(seq, dtype=np.int32)[None, None, None, :, None],
            (c, k, micro, 1, 3))
    return batch


@pytest.fixture(scope="module", params=["olmoe-1b-7b", "qwen2-vl-7b"])
def zoo(request):
    """The host-round fixture of ``test_torch_host_round.py`` for this
    arch: stacked params from PRNGKey(0), broadcast optimizer states, the
    launcher's batch (C, K, MICRO, SEQ)."""
    arch = request.param
    j_cfg = _cfg(j_get_arch, arch)
    jm = j_build(j_cfg)
    jt = JT(learning_rate=0.05, freeze_head=True, remat=False)
    jp = j_init_stacked(jm, jax.random.PRNGKey(0), C)
    jopt, _ = j_build_optimizer(jm, jt)
    s1 = jopt.init(jax.tree.map(lambda x: x[0], jp))
    js = jax.tree.map(lambda x: jnp.broadcast_to(x[None], (C,) + x.shape),
                      s1)
    cfg = _cfg(get_arch, arch)
    return dict(arch=arch, j_cfg=j_cfg, jm=jm, jt=jt, jp=jp, js=js,
                batch=reference_batch(cfg, C, K, MICRO, SEQ, seed=0),
                cfg=cfg, t=TrainConfig(learning_rate=0.05, freeze_head=True,
                                       remat=False),
                tp=_to_port(jp), ts=_to_port(js), c=C, k=K)


def test_launcher_batch_matches_reference(zoo):
    got = ttrain._client_round_batch(zoo["cfg"], C, K, MICRO, SEQ, seed=0)
    want = zoo["batch"]
    assert set(got) == set(want)
    for name in want:
        assert str(got[name].dtype).endswith(str(want[name].dtype)), name
        np.testing.assert_array_equal(got[name].numpy(), want[name])


def test_one_round_matches_reference(zoo):
    (tp, ts, tm), (jp, js, jm) = _run_both(zoo)
    _close(tp, jp)
    _close(ts, js)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), **TOL)
    assert torch.equal(tp["lm_head"]["w"], zoo["tp"]["lm_head"]["w"])


def test_head_bank_and_evaluations_match_reference(zoo):
    jp1 = jax.tree.map(lambda x: x[0], zoo["jp"])
    tp1 = _to_port(jp1)
    ft = reference_batch(zoo["cfg"], C, 1, MICRO, SEQ, seed=777)
    ft = {k: v[:, 0] for k, v in ft.items()}               # (C, MICRO, ...)
    jft = jax.tree.map(jnp.asarray, ft)
    tft = {k: torch.from_numpy(v) for k, v in ft.items()}
    jtc = JT(finetune_lr=0.05, finetune_steps=3)
    want, want_l = j_bank(zoo["jm"], jp1, jft, jtc)
    tm = build_model(zoo["cfg"])
    got, got_l = personalize_head_bank(
        tm, tp1, tft, TrainConfig(finetune_lr=0.05, finetune_steps=3))
    np.testing.assert_allclose(got_l.numpy(), np.asarray(want_l), rtol=1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    ev = personalized_eval(tm, tp1, got, tft)
    j_ev = j_eval(zoo["jm"], jp1, want, jft)
    np.testing.assert_allclose(ev.numpy(), np.asarray(j_ev), rtol=1e-5)
