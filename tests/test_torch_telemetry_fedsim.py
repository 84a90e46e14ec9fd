"""Telemetry through the port's ``FedSim`` on the reference's golden
scenario (``tests/test_telemetry.py``'s ``TestFedSimGolden``, built from
the port's ``configs/sweeps.py``): the CNN at the paper's width, 2 ESs x
4 clients, a static pipelined channel with the stale fold, erasures and
crashes, 2 global rounds, on the CPU.

- The network rows and the simulated clock equal
  ``tests/golden_fedsim_history.json``'s exactly (numpy streams on both
  sides; the history and parameters are float32 arithmetic and are held
  to the reference elsewhere, ``test_torch_fedsim_wireless.py``).
- Telemetry on changes nothing: the history and the parameter sum are
  bit-identical to the run with telemetry off.
- The files land, and the scheduler's and FedSim's instruments agree with
  the rows they describe.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import (FaultConfig, sweep_hierarchy, sweep_train,
                                 sweep_wireless)
from repro_torch.configs.phsfl_cnn import CONFIG
from repro_torch.core.fedsim import FedSim
from repro_torch.data.synthetic import make_federated_image_data
from repro_torch.telemetry import Telemetry, get_kernel_sink
from repro_torch.utils.tree import tree_leaves

GOLDEN = Path(__file__).resolve().parent / "golden_fedsim_history.json"


def _golden_sim(telemetry=None):
    data = make_federated_image_data(8, alpha=0.3, train_per_class=40,
                                     test_per_class=20, seed=0)
    w = sweep_wireless("static", deadline_s=3.0, pipeline=True,
                       staleness_lambda=0.5,
                       faults=FaultConfig(erasure_prob=0.3, max_retries=2,
                                          crash_hazard=0.2), seed=0)
    return FedSim(CONFIG, data, sweep_hierarchy(2), sweep_train(),
                  batches_per_epoch=2, seed=0, wireless=w, device="cpu",
                  telemetry=telemetry)


def _param_sum(params) -> float:
    return float(sum(t.to(torch.float64).sum() for t in tree_leaves(params)))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("golden-telemetry")
    off = _golden_sim().run(rounds=2, log_every=1)
    tel = Telemetry(str(out), kernels=True)
    sim = _golden_sim(tel)
    on = sim.run(rounds=2, log_every=1)
    tel.write_manifest(config=sim.h, seeds={"seed": 0})
    tel.close()
    return off, on, tel, out


def test_golden_network_rows_and_clock_are_the_reference_s(runs):
    off, on, _, _ = runs
    golden = json.load(open(GOLDEN))
    assert off.network == golden["network"]
    assert off.total_sim_time_s == golden["total_sim_time_s"]
    assert on.network == golden["network"]
    assert [r["round"] for r in off.history] == [
        r["round"] for r in golden["history"]]
    assert [r["mean_participants"] for r in off.history] == [
        r["mean_participants"] for r in golden["history"]]
    assert [r["sim_time_s"] for r in off.history] == [
        r["sim_time_s"] for r in golden["history"]]
    assert any(r["retx_bits"] for r in off.network)
    assert any(r["crashed"] for r in off.network)


def test_telemetry_on_is_bit_identical_to_off(runs):
    off, on, _, _ = runs
    assert on.history == off.history
    assert on.total_sim_time_s == off.total_sim_time_s
    assert _param_sum(on.global_params) == _param_sum(off.global_params)
    for a, b in zip(tree_leaves(on.global_params),
                    tree_leaves(off.global_params)):
        assert torch.equal(a, b)


def test_golden_run_files_and_instruments(runs):
    _, on, tel, out = runs
    assert get_kernel_sink() is None              # released at close
    for f in ("trace.json", "metrics.jsonl", "manifest.json", "summary.txt"):
        assert (out / f).exists(), f
    evs = json.load(open(out / "trace.json"))
    es = {e["tid"] for e in evs if e["pid"] == 2 and e["ph"] == "X"}
    assert es == {0, 1}
    snap = tel.metrics.snapshot()
    rows = on.network
    assert snap["sched.rounds"]["value"] == len(rows) == 4
    assert snap["sched.participants"]["value"] == sum(
        r["participants"] for r in rows)
    assert snap["sched.scheduled"]["value"] == sum(
        r["scheduled"] for r in rows)
    assert snap["faults.crashed"]["value"] == sum(r["crashed"] for r in rows)
    assert snap["stale.delivered"]["value"] == sum(
        r["stale_delivered"] for r in rows)
    assert snap["fedsim.rounds"]["value"] == 2
    assert snap["fedsim.agg_mass_live"]["value"] == sum(
        r["participants"] for r in rows)
    assert snap["fedsim.test_acc"]["value"] == on.history[-1]["test_acc"]
    assert not any(k.startswith("kernel.") for k in snap)   # no codec
    lines = [json.loads(ln) for ln in open(out / "metrics.jsonl")]
    # a flush per scheduler round, a forced one per logged round, close
    assert [ln["step"] for ln in lines] == [0, 1, 1, 2, 3, 2, None]
    man = json.load(open(out / "manifest.json"))
    assert "torch" in man and "jax" not in man
    assert man["config_hash"] is not None
    assert np.isfinite(snap["fedsim.round_wall_s"]["sum"])
