"""Port parity for the personalized serving slices: the head bank (Eq. 18)
and its evaluation, and ``serve()`` against the reference's
``launch/serve.py`` at small flags, with the reference's own parameters
carried in, on gemma3-12b, xlstm-350m and recurrentgemma-2b (reduced).

Tolerances (float32): 1e-5 on the head bank and the losses (four SGD
steps on cached hidden states; summation order), 1e-4 on the decode
logits (two layers, then a 512-way head).  The generated tokens and the
request profiles must be equal.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import TrainConfig as JT
from repro.configs.registry import get_arch as j_get_arch
from repro.core.personalize import personalize_head_bank as j_bank
from repro.core.personalize import personalized_eval as j_eval
from repro.data.synthetic import synthetic_token_batch
from repro.launch import serve as j_serve
from repro.models import build_model as j_build
from repro.models.layers import softcap as j_softcap
from repro_torch.configs.base import TrainConfig
from repro_torch.configs.registry import get_arch
from repro_torch.convert import params_from_numpy
from repro_torch.core.personalize import (personalize_head_bank,
                                          personalized_eval)
from repro_torch.hopper.flash_attention import kernel
from repro_torch.launch import serve as t_serve
from repro_torch.models.registry import build_model

FLAGS = dict(batch=3, steps=6, clients=2, prompt_len=5, seed=0)


def _reference(arch_kw=None, arch="gemma3-12b"):
    j_cfg = j_get_arch(arch).reduced(**(arch_kw or {}))
    jm = j_build(j_cfg)
    jp = jm.init(jax.random.PRNGKey(0))
    return j_cfg, jm, jp, params_from_numpy(jax.tree.map(np.asarray, jp),
                                            "cpu")


def _batches(clients, b, s, vocab, offset=0):
    nbs = [synthetic_token_batch(c + offset, b, s, vocab)
           for c in range(clients)]
    return {k: np.stack([nb[k] for nb in nbs]) for k in nbs[0]}


def test_head_bank_and_eval_match_reference():
    """Three clients at gemma3-12b.reduced(num_layers=12), 64-token
    sequences (past the window of 64 is not needed here: the trunk is
    held by test_torch_transformer.py)."""
    j_cfg, jm, jp, tp = _reference({"num_layers": 12})
    cfg = get_arch("gemma3-12b").reduced(num_layers=12)
    tm = build_model(cfg)
    b = _batches(3, 2, 64, cfg.vocab_size)
    held = _batches(3, 2, 64, cfg.vocab_size, offset=10)
    jt = JT(finetune_lr=0.2, finetune_steps=4)
    want, want_l = j_bank(jm, jp, jax.tree.map(jnp.asarray, b), jt)
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    before = kernel.launches
    got, got_l = personalize_head_bank(
        tm, tp, tb, TrainConfig(finetune_lr=0.2, finetune_steps=4))
    assert kernel.launches == before
    assert got.shape == want.shape and got_l.shape == want_l.shape
    np.testing.assert_allclose(got_l.numpy(), np.asarray(want_l), rtol=1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    # the heads moved, and each client's own head lowers its own loss
    assert not torch.equal(got[0], tp["lm_head"]["w"])
    assert (got_l[:, -1] < got_l[:, 0]).all()
    ev = personalized_eval(tm, tp, got, {k: torch.from_numpy(v)
                                         for k, v in held.items()})
    j_ev = j_eval(jm, jp, want, jax.tree.map(jnp.asarray, held))
    np.testing.assert_allclose(ev.numpy(), np.asarray(j_ev), rtol=1e-5)


def _reference_logits(j_cfg, jm, jp, flags):
    """The decode loop of repro.launch.serve.main, returning its logits
    (main prints only the generated tokens)."""
    batches = jax.tree.map(jnp.asarray, _batches(flags["clients"], 2, 32,
                                                 j_cfg.vocab_size))
    bank, _ = j_bank(jm, jp, batches, JT(finetune_lr=0.2, finetune_steps=4))
    rng = np.random.default_rng(flags["seed"])
    heads = bank[jnp.asarray(rng.integers(0, flags["clients"],
                                          flags["batch"]))]
    cache = jm.init_cache(flags["batch"],
                          flags["prompt_len"] + flags["steps"],
                          dtype=jnp.float32)
    prompt = jnp.asarray(rng.integers(
        0, j_cfg.vocab_size, (flags["batch"], flags["prompt_len"])).astype(
            np.int32))

    @jax.jit
    def step(tok, cache, index):
        hidden, cache = jm.decode_step(jp, tok, cache, index,
                                       return_hidden=True)
        lg = jnp.einsum("bqd,bdv->bqv", hidden.astype(jnp.float32),
                        heads.astype(jnp.float32))
        return j_softcap(lg, j_cfg.final_logit_softcap), cache

    for i in range(flags["prompt_len"] - 1):
        _, cache = step(prompt[:, i:i + 1], cache, jnp.asarray(i, jnp.int32))
    tok, out = prompt[:, -1:], []
    for s in range(flags["steps"]):
        lg, cache = step(tok, cache,
                         jnp.asarray(flags["prompt_len"] - 1 + s, jnp.int32))
        tok = lg[:, :, :j_cfg.vocab_size].argmax(-1).astype(jnp.int32)
        out.append(np.asarray(lg[:, 0]))
    return bank, np.stack(out, 1)


def test_serve_matches_reference_main(capsys):
    j_cfg, jm, jp, tp = _reference()
    argv = [f"--{k.replace('_', '-')}={v}" for k, v in FLAGS.items()]
    j_serve.main(argv)
    ref = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    bank, ref_logits = _reference_logits(j_cfg, jm, jp, FLAGS)

    res = t_serve.serve(get_arch("gemma3-12b").reduced(), params=tp,
                        device="cpu", **FLAGS)
    assert res.profiles.tolist() == ref["profiles"]
    assert res.generated.tolist() == ref["generated"]
    assert res.generated.shape == (FLAGS["batch"], FLAGS["steps"])
    np.testing.assert_allclose(res.head_bank.numpy(), np.asarray(bank),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(res.logits.numpy(), ref_logits, rtol=1e-4,
                               atol=1e-4)
    assert res.tokens == FLAGS["batch"] * (FLAGS["steps"]
                                           + FLAGS["prompt_len"] - 1)


def test_xlstm_head_bank_and_serve_match_reference():
    """xlstm-350m.reduced(num_layers=6) (mLSTM and sLSTM layers in the
    lead, scan and tail stages): the head bank over one trunk forward,
    then the decode loop through the recurrent caches, against the
    reference's serving loop.  On the CPU K3 takes its plain version."""
    from repro_torch.hopper.mlstm_chunk import kernel as k3
    j_cfg, jm, jp, tp = _reference({"num_layers": 6}, arch="xlstm-350m")
    bank, ref_logits = _reference_logits(j_cfg, jm, jp, FLAGS)
    before = k3.launches
    res = t_serve.serve(get_arch("xlstm-350m").reduced(num_layers=6),
                        params=tp, device="cpu", **FLAGS)
    assert k3.launches == before
    np.testing.assert_allclose(res.head_bank.numpy(), np.asarray(bank),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(res.logits.numpy(), ref_logits, rtol=1e-4,
                               atol=1e-4)
    assert res.generated.tolist() == np.asarray(
        ref_logits)[..., :j_cfg.vocab_size].argmax(-1).tolist()


def test_xlstm_serve_matches_reference_main(capsys):
    """``--arch xlstm-350m``: the reference's main at its flags (the
    reduced config, two layers) against ``serve()`` with its parameters."""
    _, _, _, tp = _reference(arch="xlstm-350m")
    argv = [f"--{k.replace('_', '-')}={v}" for k, v in FLAGS.items()]
    j_serve.main(argv + ["--arch=xlstm-350m"])
    ref = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    res = t_serve.serve(get_arch("xlstm-350m").reduced(), params=tp,
                        device="cpu", **FLAGS)
    assert res.profiles.tolist() == ref["profiles"]
    assert res.generated.tolist() == ref["generated"]


def test_recurrentgemma_head_bank_and_serve_match_reference():
    """recurrentgemma-2b.reduced(num_layers=8) (RG-LRU and local-attention
    layers in the lead, scan and tail stages): the head bank over one
    trunk forward, then the decode loop through the RG-LRU caches and the
    attention rings, against the reference's serving loop.  On the CPU K4
    and K2 take their plain versions."""
    from repro_torch.hopper.rglru_scan import kernel as k4
    j_cfg, jm, jp, tp = _reference({"num_layers": 8},
                                   arch="recurrentgemma-2b")
    bank, ref_logits = _reference_logits(j_cfg, jm, jp, FLAGS)
    before = (k4.launches, kernel.launches)
    res = t_serve.serve(get_arch("recurrentgemma-2b").reduced(num_layers=8),
                        params=tp, device="cpu", **FLAGS)
    assert (k4.launches, kernel.launches) == before
    np.testing.assert_allclose(res.head_bank.numpy(), np.asarray(bank),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(res.logits.numpy(), ref_logits, rtol=1e-4,
                               atol=1e-4)
    assert res.generated.tolist() == np.asarray(
        ref_logits)[..., :j_cfg.vocab_size].argmax(-1).tolist()


def test_recurrentgemma_serve_matches_reference_main(capsys):
    """``--arch recurrentgemma-2b``: the reference's main at its flags (the
    reduced config, two RG-LRU layers) against ``serve()`` with its
    parameters."""
    _, _, _, tp = _reference(arch="recurrentgemma-2b")
    argv = [f"--{k.replace('_', '-')}={v}" for k, v in FLAGS.items()]
    j_serve.main(argv + ["--arch=recurrentgemma-2b"])
    ref = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    res = t_serve.serve(get_arch("recurrentgemma-2b").reduced(), params=tp,
                        device="cpu", **FLAGS)
    assert res.profiles.tolist() == ref["profiles"]
    assert res.generated.tolist() == ref["generated"]


def test_main_prints_the_reference_fields(capsys):
    res = t_serve.main(["--device", "cpu", "--batch", "2", "--steps", "3",
                        "--clients", "2", "--prompt-len", "4"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(out) == {"generated", "profiles", "tok_per_s"}
    assert np.array(out["generated"]).shape == (2, 3)
    assert out["generated"] == res.generated.tolist()
    assert torch.isfinite(res.logits).all()


def test_main_serves_xlstm_on_the_cpu(capsys):
    res = t_serve.main(["--arch", "xlstm-350m", "--device", "cpu",
                        "--batch", "2", "--steps", "3", "--clients", "2",
                        "--prompt-len", "4"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["generated"] == res.generated.tolist()
    assert np.array(out["generated"]).shape == (2, 3)
    assert torch.isfinite(res.logits).all()


def test_main_serves_recurrentgemma_on_the_cpu(capsys):
    res = t_serve.main(["--arch", "recurrentgemma-2b", "--device", "cpu",
                        "--batch", "2", "--steps", "3", "--clients", "2",
                        "--prompt-len", "4"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["generated"] == res.generated.tolist()
    assert np.array(out["generated"]).shape == (2, 3)
    assert torch.isfinite(res.logits).all()


def test_serve_runs_on_the_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_serve.serve(get_arch("gemma3-12b").reduced(), batch=1, steps=1,
                      clients=1, prompt_len=2)
