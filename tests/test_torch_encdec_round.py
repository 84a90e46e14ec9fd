"""Port parity for LM training under the reference's default
``TrainConfig`` (``remat=True``, policy "full"; SGD at 0.01, the head
frozen) and for the encoder-decoder's training inputs: one round of
``make_host_round`` against the reference's host round on
seamless-m4t-medium and xlstm-350m at ``reduced()``, in-process as
``test_torch_host_round.py`` runs it, with the reference's parameters and
optimizer states carried in; seamless's head bank (Eq. 18) and both
evaluations with ``source_embeds`` in the batch; and the launcher's
``_client_round_batch`` against the reference's formula, source frames
included (``repro.launch.train._client_round_batch``, rebuilt here: its
module imports ``repro.wireless``, which fails on this jax, R1).

Tolerances: the reference host round's own, rtol 2e-5 / atol 2e-6
(``tests/test_host_round.py:78-79``), and the serving tests' 1e-5 on the
head bank and the evaluations.  The frozen head stays bit for bit.
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
from repro.core import init_stacked_params as j_init_stacked
from repro.core import make_host_round as j_make_host_round
from repro.core.personalize import personalize_head_bank as j_bank
from repro.core.personalize import personalized_eval as j_eval
from repro.data.synthetic import synthetic_token_batch
from repro.models import build_model as j_build
from repro_torch.configs.base import HierarchyConfig, TrainConfig
from repro_torch.configs.registry import get_arch
from repro_torch.core.personalize import (personalize_head_bank,
                                          personalized_eval)
from repro_torch.core.phsfl import make_host_round
from repro_torch.launch import train as ttrain
from repro_torch.models.registry import build_model
from test_torch_host_round import TOL, _close, _to_port

C, K, MICRO, SEQ = 2, 1, 2, 16


def reference_batch(cfg, c, k, micro, seq, seed):
    """The reference launcher's batch as numpy, the encoder-decoder's
    source frames of 0.02 included."""
    toks, labs = [], []
    for i in range(c):
        nb = synthetic_token_batch(seed * 1000 + i, k * micro, seq,
                                   max(cfg.vocab_size // 2, 2))
        shift = (i * cfg.vocab_size) // (2 * max(c, 1))
        toks.append((nb["tokens"] + shift) % cfg.vocab_size)
        labs.append((nb["labels"] + shift) % cfg.vocab_size)
    batch = {"tokens": np.stack(toks).reshape(c, k, micro, seq),
             "labels": np.stack(labs).reshape(c, k, micro, seq)}
    if cfg.encdec is not None:
        batch["source_embeds"] = 0.02 * np.ones(
            (c, k, micro, cfg.encdec.max_source_len, cfg.d_model),
            np.float32)
    return batch


@pytest.fixture(scope="module",
                params=["seamless-m4t-medium", "xlstm-350m"])
def run(request):
    """One edge round of C clients, K local steps, under the default
    TrainConfig on both sides, from the reference's stacked parameters
    (PRNGKey(0)) and optimizer states, on the launcher's batch."""
    arch = request.param
    j_cfg, cfg = j_get_arch(arch).reduced(), get_arch(arch).reduced()
    jm = j_build(j_cfg)
    jt = JT()
    assert jt.remat and jt.remat_policy == "full"
    jp = j_init_stacked(jm, jax.random.PRNGKey(0), C)
    jopt, _ = j_build_optimizer(jm, jt)
    s1 = jopt.init(jax.tree.map(lambda x: x[0], jp))
    js = jax.tree.map(lambda x: jnp.broadcast_to(x[None], (C,) + x.shape),
                      s1)
    batch = reference_batch(cfg, C, K, MICRO, SEQ, seed=0)
    au = np.full((C,), 1.0 / C, np.float32)
    ab = np.ones((C,), np.float32)
    jh = JH(num_edge_servers=1, clients_per_es=C, kappa0=K, kappa1=1)
    want = jax.jit(j_make_host_round(jm, jh, jt, num_clients=C,
                                     global_sync=False).fn)(
        jp, js, jax.tree.map(jnp.asarray, batch), jnp.asarray(au),
        jnp.asarray(ab))
    th = HierarchyConfig(num_edge_servers=1, clients_per_es=C, kappa0=K,
                         kappa1=1)
    tp, ts = _to_port(jp), _to_port(js)
    got = make_host_round(build_model(cfg), th, TrainConfig(),
                          num_clients=C, global_sync=False).fn(
        tp, ts, {n: torch.from_numpy(v) for n, v in batch.items()},
        torch.from_numpy(au), torch.from_numpy(ab))
    return dict(arch=arch, cfg=cfg, j_cfg=j_cfg, jm=jm, jp=jp, tp=tp,
                batch=batch, got=got, want=want)


def test_launcher_batch_matches_reference(run):
    got = ttrain._client_round_batch(run["cfg"], C, K, MICRO, SEQ, seed=0)
    want = run["batch"]
    assert set(got) == set(want)
    for name in want:
        assert str(got[name].dtype).endswith(str(want[name].dtype)), name
        np.testing.assert_array_equal(got[name].numpy(), want[name])


def test_default_train_config_round_matches_reference(run):
    (tp, ts, tm), (jp, js, jm) = run["got"], run["want"]
    _close(tp, jp)
    _close(ts, js)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), **TOL)
    assert torch.equal(tp["lm_head"]["w"], run["tp"]["lm_head"]["w"])


def test_head_bank_and_evaluations_match_reference(run):
    """The head bank over one trunk pass of every client's batch (the
    encoder over each sequence's frames first, for seamless), then the
    personalized and the global evaluations."""
    jp1 = jax.tree.map(lambda x: x[0], run["jp"])
    tp1 = _to_port(jp1)
    ft = reference_batch(run["cfg"], C, 1, MICRO, SEQ, seed=777)
    ft = {k: v[:, 0] for k, v in ft.items()}               # (C, MICRO, ...)
    jft = jax.tree.map(jnp.asarray, ft)
    tft = {k: torch.from_numpy(v) for k, v in ft.items()}
    jtc = JT(finetune_lr=0.05, finetune_steps=3)
    want, want_l = j_bank(run["jm"], jp1, jft, jtc)
    tm = build_model(run["cfg"])
    got, got_l = personalize_head_bank(
        tm, tp1, tft, TrainConfig(finetune_lr=0.05, finetune_steps=3))
    np.testing.assert_allclose(got_l.numpy(), np.asarray(want_l), rtol=1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    for head, j_head in ((got, want), (
            tp1["lm_head"]["w"][None].expand(got.shape),
            jnp.broadcast_to(jp1["lm_head"]["w"][None], want.shape))):
        ev = personalized_eval(tm, tp1, head, tft)
        j_ev = j_eval(run["jm"], jp1, j_head, jft)
        np.testing.assert_allclose(ev.numpy(), np.asarray(j_ev), rtol=1e-5)


def test_launcher_trains_seamless_on_the_cpu(capsys):
    """``launch/train.py --arch seamless-m4t-medium``: the reduced config,
    its batches with source frames, one round, the head bank and both
    evaluations; the reference's JSON keys, finite."""
    import json
    res = ttrain.main(["--device", "cpu", "--arch", "seamless-m4t-medium",
                       "--rounds", "1", "--clients", "2", "--seq", "16",
                       "--local-steps", "1", "--finetune-steps", "2"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(out) == {"final_loss", "personalization_gain"}
    assert np.isfinite(out["final_loss"])
    assert res.head_bank.shape[0] == 2
    assert torch.isfinite(res.personalized_eval).all()
