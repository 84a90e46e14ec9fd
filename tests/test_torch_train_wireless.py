"""Port parity for the training driver's network modes
(``repro_torch.launch.train --channel ...``) against the reference's
``repro.launch.train``.

Two networks on gemma3-12b's reduced config, 2 rounds:
- ``channel``: rayleigh fading with a binding deadline, an energy budget,
  finite compute and the greedy cut policy over client depths 1 and 2;
- ``population``: a 16-client registry, 4 training slots a round sampled
  by the ``CohortScheduler`` (the port's core on the CPU; the
  reference's steps through its numpy oracle), with a shared ES uplink.
The reference runs in-process under ``reference_wireless`` (the R1 shim)
and writes its state checkpoint every round.  Checked:
- a fresh port run logs the reference's network keys, equal, every round;
- the port resumed from the reference's round-1 state (its scheduler's
  streams and budgets included) logs the reference's round 2 and ends
  with its final JSON: the network numbers equal, losses and parameters
  within ``test_torch_train.py``'s tolerance, the scheduler's state equal;
- the port's own kill-and-resume with an erasure plan in the fault stream
  is bit-identical;
- ``--trace-dir`` (on the reference's runs too: its telemetry changes no
  number) writes the reference's files: ``trace.json``'s events equal,
  every ``metrics.jsonl`` line's ``sched.*``, ``energy.*``, ``stale.*`` and
  ``faults.*`` equal, its ``log.train.*`` equal on the network keys and
  within the tolerance on losses, ``manifest.json`` with the reference's
  keys (``"torch"`` for ``"jax"``).  ``kernel.*`` differ by design: the
  reference's round is jitted, so its probes count traced calls.
"""

import contextlib
import dataclasses
import io
import json
import os
import shutil

import numpy as np
import pytest

from test_torch_wireless_oracle import reference_wireless

from repro_torch.convert import params_from_numpy
from repro_torch.launch import train as ttrain

BASE = ["--arch", "gemma3-12b", "--rounds", "2", "--clients", "4", "--seq",
        "16", "--local-steps", "1", "--micro", "1", "--finetune-steps", "2",
        "--channel", "rayleigh", "--deadline", "0.3"]
CASES = {
    "channel": ["--cut-policy", "greedy", "--cut-candidates", "1", "2",
                "--compute-gflops", "20", "--energy-budget", "5"],
    "population": ["--population", "16", "--sampling", "pareto",
                   "--es-uplink-mbps", "200"],
}
NET = ("participants", "round_time_s", "sim_time_s", "bits_tx", "mean_cut",
       "compute_s_max")
TOL = dict(rtol=2e-5, atol=2e-6)
STEP = "ckpt_00000002.npz"


def _records(text):
    lines = text.strip().splitlines()
    steps = [json.loads(ln.split(" ", 1)[1]) for ln in lines[:-1]
             if ln.startswith("[train]") and '"step"' in ln]
    return steps, json.loads(lines[-1])


@pytest.fixture(scope="module")
def reference_runs(tmp_path_factory):
    """Each case's reference run, checkpointing its state every round."""
    out = {}
    with reference_wireless():
        from repro.launch.train import main
        for name, flags in CASES.items():
            d = tmp_path_factory.mktemp(f"reference-{name}")
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                main(BASE + flags + ["--ckpt-dir", str(d),
                                     "--ckpt-every", "1",
                                     "--trace-dir", str(d / "trace")])
            out[name] = (d, *_records(buf.getvalue()))
    return out


def _port(argv, capsys):
    ttrain.main(["--device", "cpu", *argv])
    return _records(capsys.readouterr().out)


@pytest.mark.parametrize("name", sorted(CASES))
def test_network_rows_match_reference(reference_runs, name, capsys):
    _, want_steps, want_out = reference_runs[name]
    steps, out = _port(BASE + CASES[name], capsys)
    assert len(steps) == len(want_steps) == 2
    for got, want in zip(steps, want_steps):
        assert {k: got[k] for k in NET if k in got} == {
            k: want[k] for k in NET if k in want}
    for k in ("sim_time_s", "energy_left_j_min"):
        assert out[k] == want_out[k], k
    assert set(out) == set(want_out)
    parts = [s["participants"] for s in want_steps]
    assert any(0 < p < 4 for p in parts) or 0 in parts, parts


def _close_state(a, b):
    with np.load(a) as x, np.load(b) as y:
        assert sorted(x.files) == sorted(y.files)
        for k in x.files:
            assert x[k].dtype == y[k].dtype and x[k].shape == y[k].shape, k
            if k.startswith("scheduler/") or x[k].dtype.kind in "iu":
                assert np.array_equal(x[k], y[k]), k
            else:
                np.testing.assert_allclose(x[k], y[k], **TOL, err_msg=k)


@pytest.mark.parametrize("name", sorted(CASES))
def test_resume_from_reference_state_matches_reference(
        reference_runs, name, tmp_path, capsys):
    ref_dir, want_steps, want_out = reference_runs[name]
    os.makedirs(tmp_path / "state")
    shutil.copy(ref_dir / "state" / "ckpt_00000001.npz", tmp_path / "state")
    steps, out = _port(BASE + CASES[name] + [
        "--ckpt-dir", str(tmp_path), "--ckpt-every", "1", "--resume"],
        capsys)
    assert [s["step"] for s in steps] == [1]
    got, want = steps[0], want_steps[1]
    assert {k: got[k] for k in NET if k in got} == {
        k: want[k] for k in NET if k in want}
    np.testing.assert_allclose(got["loss"], want["loss"], **TOL)
    assert set(out) == set(want_out)
    for k in out:
        np.testing.assert_allclose(out[k], want_out[k], **TOL, err_msg=k)
    _close_state(tmp_path / "state" / STEP, ref_dir / "state" / STEP)
    with np.load(tmp_path / STEP) as x, np.load(ref_dir / STEP) as y:
        for k in y.files:
            np.testing.assert_allclose(x[k], y[k], **TOL, err_msg=k)


EXACT = ("sched.", "energy.", "stale.", "faults.")
LOG_EXACT = NET + ("step", "client", "ckpt")
LOG_SKIP = ("s_per_round",)


def _telemetry_files(d):
    evs = json.load(open(d / "trace.json"))
    lines = [json.loads(ln) for ln in open(d / "metrics.jsonl")]
    return evs, lines, json.load(open(d / "manifest.json"))


@pytest.fixture(scope="module")
def reference_init():
    """The reference ``main``'s initial parameters (one replica, numpy)."""
    import jax
    from repro.configs.registry import get_arch as j_arch
    from repro.models.registry import build_model as j_build
    params = j_build(j_arch("gemma3-12b").reduced()).init(
        jax.random.PRNGKey(0))
    return jax.tree.map(np.asarray, params)


@pytest.mark.parametrize("name", sorted(CASES))
def test_trace_dir_writes_the_reference_files(reference_runs, reference_init,
                                              name, tmp_path, capsys,
                                              monkeypatch):
    ref_dir, want_steps, want_out = reference_runs[name]
    build = ttrain.build_model

    def from_reference_init(cfg):
        # the port's main draws its weights from torch's streams; start it
        # from the reference's so the losses can be held to them
        return dataclasses.replace(build(cfg), init=lambda gen, dtype=None:
                                   params_from_numpy(reference_init, "cpu"))

    monkeypatch.setattr(ttrain, "build_model", from_reference_init)
    steps, out = _port(BASE + CASES[name] + [
        "--ckpt-dir", str(tmp_path), "--ckpt-every", "1",
        "--trace-dir", str(tmp_path / "trace")], capsys)
    assert [{k: s[k] for k in NET if k in s} for s in steps] == [
        {k: s[k] for k in NET if k in s} for s in want_steps]
    for f in ("trace.json", "metrics.jsonl", "manifest.json", "summary.txt"):
        assert (tmp_path / "trace" / f).exists(), f
    evs, lines, man = _telemetry_files(tmp_path / "trace")
    want_evs, want_lines, want_man = _telemetry_files(ref_dir / "trace")
    assert evs == want_evs
    assert len(lines) == len(want_lines) == 3     # 2 rounds + close
    for got, want in zip(lines, want_lines):
        assert got["step"] == want["step"]
        g, w = got["metrics"], want["metrics"]
        keys = {k for k in w if k.startswith(EXACT)}
        assert keys and {k for k in g if k.startswith(EXACT)} == keys
        assert {k: g[k] for k in keys} == {k: w[k] for k in keys}
        logs = {k for k in w if k.startswith("log.train.")}
        assert {k for k in g if k.startswith("log.train.")} == logs
        for k in logs:
            if k.endswith(LOG_SKIP):
                continue
            if k.rsplit(".", 1)[1] in LOG_EXACT:
                assert g[k] == w[k], k
            else:
                np.testing.assert_allclose(g[k]["value"], w[k]["value"],
                                           **TOL, err_msg=k)
    assert set(man) - {"torch"} == set(want_man) - {"jax"}
    assert man["torch"]["backend"] == "cpu"
    assert man["seeds"] == want_man["seeds"] == {"seed": 0}
    assert (man["arch"], man["clients"]) == (want_man["arch"],
                                             want_man["clients"])


def test_kill_and_resume_replays_the_fault_schedule(tmp_path, capsys):
    flags = BASE + CASES["population"] + ["--erasure-prob", "0.3",
                                          "--ckpt-every", "1"]
    w_steps, w_out = _port(flags + ["--ckpt-dir", str(tmp_path / "w")],
                           capsys)
    ttrain.main(["--device", "cpu", *flags, "--ckpt-dir",
                 str(tmp_path / "k"), "--abort-after", "1"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == {
        "aborted_after_round": 1}
    r_steps, r_out = _port(flags + ["--ckpt-dir", str(tmp_path / "k"),
                                    "--resume"], capsys)
    assert r_out == w_out
    strip = [{k: v for k, v in s.items() if k not in ("t", "s_per_round")}
             for s in (w_steps[1], r_steps[0])]
    assert strip[0] == strip[1]
    for name in (STEP, f"state/{STEP}"):
        with np.load(tmp_path / "w" / name) as x, \
                np.load(tmp_path / "k" / name) as y:
            assert sorted(x.files) == sorted(y.files)
            assert any(k.startswith("scheduler/fault_rng")
                       for k in x.files) or name == STEP
            for k in x.files:
                assert x[k].tobytes() == y[k].tobytes(), (name, k)
