"""Port parity for the training driver (``repro_torch.launch.train``)
against the reference's ``repro.launch.train``.

- ``_client_round_batch`` equals the reference's formula (rebuilt here
  from ``repro.data.synthetic``) element for element.
- ``main`` resumed from a state checkpoint that the reference's ``main``
  wrote after round 1 agrees with the reference's uninterrupted run at
  ``--rounds 2 --clients 2 --seq 64``: the final JSON, the final-params
  file and the round-2 state file, at the reference's host-round
  tolerance (rtol 2e-5, atol 2e-6, ``tests/test_host_round.py:78-79``).
  The reference runs in a subprocess with a stub ``repro.wireless`` in
  ``sys.modules``: its ``launch/train.py`` imports ``make_scheduler`` at
  the top (``train.py:40``), and the real package fails to import on
  this jax (R1 in ROADMAP.md); the ideal network never calls it.
- The port's own kill-and-resume is bit-identical, and with no card
  ``main`` and ``train`` raise unless the CPU is asked for.  The network
  modes and ``--trace-dir`` are ``test_torch_train_wireless.py``'s.
"""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.data.synthetic import synthetic_token_batch as j_synthetic
from repro_torch.configs.registry import get_arch
from repro_torch.launch import train as ttrain

ROOT = Path(__file__).resolve().parent.parent
FLAGS = ["--rounds", "2", "--clients", "2", "--seq", "64"]
TOL = dict(rtol=2e-5, atol=2e-6)
STEP = "ckpt_00000002.npz"
ALL_THREADS = torch.get_num_threads()


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


@pytest.fixture
def all_threads():
    """Every thread, for the bit-for-bit checks: an order that depends on
    the threads (F2's embedding backward) shows only with several."""
    torch.set_num_threads(ALL_THREADS)
    yield
    torch.set_num_threads(1)

_REFERENCE = r"""
import sys, types
stub = types.ModuleType("repro.wireless")
def make_scheduler(*a, **k):
    raise RuntimeError("the ideal network never schedules")
stub.make_scheduler = make_scheduler
sys.modules["repro.wireless"] = stub
from repro.launch.train import main
main(sys.argv[1:])
"""


def _reference_batch(cfg, C, k, micro, seq, seed):
    toks, labs = [], []
    for c in range(C):
        nb = j_synthetic(seed * 1000 + c, k * micro, seq,
                         max(cfg.vocab_size // 2, 2))
        shift = (c * cfg.vocab_size) // (2 * max(C, 1))
        toks.append((nb["tokens"] + shift) % cfg.vocab_size)
        labs.append((nb["labels"] + shift) % cfg.vocab_size)
    return {"tokens": np.stack(toks).reshape(C, k, micro, seq),
            "labels": np.stack(labs).reshape(C, k, micro, seq)}


@pytest.mark.parametrize("arch,C,k,micro,seq,seed", [
    ("xlstm-350m", 2, 2, 2, 64, 0), ("xlstm-350m", 4, 1, 2, 32, 777),
    ("gemma3-12b", 3, 2, 1, 16, 5), ("recurrentgemma-2b", 5, 1, 3, 8, 2)])
def test_client_round_batch_matches_reference(arch, C, k, micro, seq, seed):
    cfg = get_arch(arch).reduced()
    got = ttrain._client_round_batch(cfg, C, k, micro, seq, seed)
    want = _reference_batch(cfg, C, k, micro, seq, seed)
    assert set(got) == set(want)
    for name in want:
        assert got[name].dtype == torch.int32
        np.testing.assert_array_equal(got[name].numpy(), want[name])


def _port_main(argv, capsys):
    res = ttrain.main(argv)
    lines = capsys.readouterr().out.strip().splitlines()
    return res, lines


@pytest.fixture(scope="module")
def reference_run(tmp_path_factory):
    """The reference's uninterrupted 2-round run, checkpointing its state
    every round, in a subprocess (about half a minute here)."""
    d = tmp_path_factory.mktemp("reference")
    out = subprocess.run(
        [sys.executable, "-c", _REFERENCE, *FLAGS, "--ckpt-dir", str(d),
         "--ckpt-every", "1"],
        capture_output=True, text=True, timeout=600, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src"),
             "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr[-3000:]
    return d, json.loads(out.stdout.strip().splitlines()[-1])


def _close_files(a, b, **tol):
    with np.load(a) as x, np.load(b) as y:
        assert sorted(x.files) == sorted(y.files)
        for k in x.files:
            assert x[k].dtype == y[k].dtype and x[k].shape == y[k].shape, k
            if tol:
                np.testing.assert_allclose(x[k], y[k], **tol, err_msg=k)
            else:
                assert x[k].tobytes() == y[k].tobytes(), k


def test_resume_from_reference_state_matches_reference_run(
        reference_run, tmp_path, capsys):
    ref_dir, ref_json = reference_run
    os.makedirs(tmp_path / "state")
    shutil.copy(ref_dir / "state" / "ckpt_00000001.npz", tmp_path / "state")
    res, lines = _port_main(["--device", "cpu", *FLAGS, "--ckpt-dir",
                             str(tmp_path), "--ckpt-every", "1",
                             "--resume"], capsys)
    assert res.start_round == 1 and len(res.losses) == 1
    assert '"resumed_from_round": 1.0' in lines[0]
    got = json.loads(lines[-1])
    assert set(got) == set(ref_json) == {"final_loss",
                                         "personalization_gain"}
    for key in got:
        np.testing.assert_allclose(got[key], ref_json[key], **TOL,
                                   err_msg=key)
    _close_files(tmp_path / STEP, ref_dir / STEP, **TOL)
    _close_files(tmp_path / "state" / STEP, ref_dir / "state" / STEP, **TOL)


def test_train_lines_carry_the_reference_keys(tmp_path, capsys):
    res, lines = _port_main(["--device", "cpu", "--rounds", "1",
                             "--clients", "2", "--seq", "16",
                             "--local-steps", "1", "--micro", "1",
                             "--finetune-steps", "2"], capsys)
    recs = [json.loads(ln.split(" ", 1)[1]) for ln in lines[:-1]]
    assert set(recs[0]) == {"t", "step", "loss", "s_per_round"}
    assert [set(r) - {"t"} for r in recs[1:]] == [
        {"client", "global_loss", "personalized_loss"}] * 2 + [
        {"personalization_gain"}]
    out = json.loads(lines[-1])
    assert set(out) == {"final_loss", "personalization_gain"}
    assert np.isfinite(out["final_loss"])
    assert res.head_bank.shape[0] == 2 and res.finetune_losses.shape == (
        2, 2)
    assert res.peak_mem_GB is None           # no device number on the CPU


def test_kill_and_resume_is_bit_identical(tmp_path, capsys, all_threads):
    # two rounds of two clients as FLAGS, at one local step over 16
    # tokens: the same resume path at an eighth of the sLSTM loop's steps
    # a round
    flags = ["--device", "cpu", "--rounds", "2", "--clients", "2", "--seq",
             "16", "--local-steps", "1", "--finetune-steps", "2",
             "--ckpt-every", "1"]
    whole, w_lines = _port_main(flags + ["--ckpt-dir",
                                         str(tmp_path / "w")], capsys)
    cut, c_lines = _port_main(flags + ["--ckpt-dir", str(tmp_path / "k"),
                                       "--abort-after", "1"], capsys)
    assert json.loads(c_lines[-1]) == {"aborted_after_round": 1}
    assert not (tmp_path / "k" / STEP).exists()
    resumed, r_lines = _port_main(flags + ["--ckpt-dir",
                                           str(tmp_path / "k"), "--resume"],
                                  capsys)
    assert json.loads(w_lines[-1]) == json.loads(r_lines[-1])
    for name in (STEP, f"state/{STEP}"):
        _close_files(tmp_path / "w" / name, tmp_path / "k" / name)
    # resuming an already complete run trains nothing and reports nan
    again, a_lines = _port_main(flags + ["--ckpt-dir", str(tmp_path / "k"),
                                         "--resume"], capsys)
    assert again.losses == [] and np.isnan(json.loads(a_lines[-1])[
        "final_loss"])


def test_codec_flags_have_no_effect_on_the_ideal_network(capsys):
    base = ["--device", "cpu", "--rounds", "1", "--clients", "2", "--seq",
            "16", "--local-steps", "1"]
    _, plain = _port_main(base, capsys)
    _, coded = _port_main(base + ["--codec", "int8", "--cut-policy",
                                  "greedy", "--erasure-prob", "0.5"],
                          capsys)
    assert plain[-1] == coded[-1]


def test_population_on_the_ideal_network_is_a_usage_error():
    with pytest.raises(SystemExit):
        ttrain.main(["--device", "cpu", "--population", "8"])


def test_no_card_raises_unless_cpu_is_asked_for():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrain.main(["--rounds", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrain.train(get_arch("xlstm-350m").reduced(), rounds=1)


def test_local_step_gradients_repeat_bit_for_bit(all_threads):
    """What the bit-identical resume rests on: the same step twice gives
    the same gradients, bit for bit, with repeated tokens summed into the
    embedding's rows by several threads (the CPU's ``index_put_`` with
    accumulate, an indexing backward, does not repeat)."""
    from repro_torch.models.registry import build_model
    from repro_torch.utils.prng import make_generator
    from repro_torch.utils.tree import tree_leaves, tree_map
    cfg = get_arch("gemma3-12b").reduced()
    model = build_model(cfg)
    params = model.init(make_generator(0))
    batch = ttrain._client_round_batch(cfg, 1, 1, 16, 128, seed=3)
    mb = {k: v[0, 0] for k, v in batch.items()}

    def grads():
        leaves = tree_map(lambda t: t.detach().requires_grad_(), params)
        return torch.autograd.grad(model.loss(leaves, mb),
                                   tree_leaves(leaves))

    first = grads()
    for _ in range(3):
        assert all(torch.equal(a, b) for a, b in zip(first, grads()))
