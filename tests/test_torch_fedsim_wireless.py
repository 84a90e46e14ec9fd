"""Port parity for FedSim's network modes: the reference ``FedSim`` and the
port's on the same data, seed and scheduler, the reference's initial
parameters and scheduler state carried in through ``load_state_dict``,
two global rounds of kappa1 = 2 edge rounds each.

Four networks, each exercising one mode of the aggregation:
- ``rayleigh``: a binding deadline, so rounds with no participant (the
  edge model is kept) and partial rounds (renormalized weights) occur;
- ``stale``: lambda = 0.5 with random thinning, so banked straggler
  updates are delivered and folded with weight alpha_u * lambda**s;
- ``outage``: an ES outage with ``reassoc`` failover (mapped weights,
  the fallback of an ES that aggregated nothing, ``es_mask``);
- ``population``: 64 registered clients, 4 training slots a round,
  sampled by the ``CohortScheduler`` (the port's core, on the CPU; the
  reference's steps through its numpy oracle).
Network rows come from the same numpy streams and must be EQUAL; losses,
accuracies and parameters agree within ``test_torch_fedsim.py``'s
no-codec tolerance.  The port's ``save``/``restore`` resumes a run bit
for bit, the scheduler's state and the stale bank included.

The reference runs record into an in-memory ``Telemetry``: the port's
``fedsim.*`` and ``sched.*`` instruments under ``FedSim(telemetry=)``
equal the reference's, the loss gauges within the same tolerance.  The
reference's telemetry is not bit-inert under the stale fold (R5 in
ROADMAP.md: with telemetry on, an ES whose only update this global round
was a stale delivery joins the global average), so its ``stale`` run is
made with telemetry off and a second one records the instruments.
"""

import numpy as np
import pytest
import torch

from test_torch_wireless_oracle import reference_wireless

from repro_torch.configs import (CNNConfig, FaultConfig, HierarchyConfig,
                                 TrainConfig, WirelessConfig)
from repro_torch.core.fedsim import FedSim
from repro_torch.data.synthetic import make_federated_image_data
from repro_torch.telemetry import Telemetry
from repro_torch.utils.tree import tree_leaves
from repro_torch.wireless.population import Population

SMALL = dict(image_size=16, conv1_filters=8, conv2_filters=16, fc_hidden=32)
H = dict(num_edge_servers=2, clients_per_es=2, kappa0=2, kappa1=2,
         global_rounds=2)
T = dict(learning_rate=0.05, batch_size=8, finetune_steps=3, finetune_lr=0.05)
DATA = dict(image_size=16, train_per_class=30, test_per_class=10, seed=0)
BASE = dict(mean_uplink_mbps=8.0, mean_downlink_mbps=30.0, latency_s=0.01,
            energy_budget_j=20.0, tx_power_w=0.7, heterogeneity=0.5, seed=3)
# no codec: the two sides differ by float32 summation order only
RTOL, ATOL = 1e-4, 1e-5

NETWORKS = {
    "rayleigh": dict(model="rayleigh", deadline_s=0.06, **BASE),
    "stale": dict(model="rayleigh", deadline_s=0.1, staleness_lambda=0.5,
                  selection="random", participation_prob=0.5,
                  **{**BASE, "seed": 0}),
    "outage": dict(model="rayleigh", deadline_s=0.2, es_uplink_mbps=12.0,
                   contention="proportional",
                   faults=dict(es_outage_trace=((0, 1), (0, 0), (1, 0))),
                   **BASE),
    "population": dict(model="rayleigh", deadline_s=2.0, es_uplink_mbps=12.0,
                       contention="proportional", **BASE),
}
POPULATION = dict(num_es=2, seed=3, assignment="kmeans", data_sigma=0.5)


def _wireless(name, wireless_cls, fault_cls):
    kw = dict(NETWORKS[name])
    if "faults" in kw:
        kw["faults"] = fault_cls(**kw["faults"])
    return wireless_cls(**kw)


def _port_sim(name, population=None, telemetry=None):
    return FedSim(CNNConfig(**SMALL), make_federated_image_data(4, 0.5,
                                                                **DATA),
                  HierarchyConfig(**H), TrainConfig(**T),
                  batches_per_epoch=2, seed=0,
                  wireless=_wireless(name, WirelessConfig, FaultConfig),
                  population=population, sampling="rate", device="cpu",
                  telemetry=telemetry)


def _reference_run(name):
    import jax
    from repro.configs.base import FaultConfig as JF
    from repro.configs.base import HierarchyConfig as JH
    from repro.configs.base import TrainConfig as JT
    from repro.configs.base import WirelessConfig as JW
    from repro.configs.phsfl_cnn import CNNConfig as JC
    from repro.core.fedsim import FedSim as JFedSim
    from repro.data.synthetic import make_federated_image_data as j_data
    from repro.telemetry import Telemetry as JTelemetry
    from repro.wireless.population import Population as JPopulation

    def build(telemetry=None):
        pop = JPopulation(64, **POPULATION) if name == "population" else None
        return JFedSim(JC(**SMALL), j_data(4, 0.5, **DATA), JH(**H),
                       JT(**T), batches_per_epoch=2, seed=0,
                       wireless=_wireless(name, JW, JF), population=pop,
                       sampling="rate", telemetry=telemetry)

    tel = JTelemetry()                        # enabled, in memory
    sim = build(None if name == "stale" else tel)
    state = jax.tree.map(np.asarray, sim.state_dict())
    res = sim.run(rounds=2, log_every=1)
    if name == "stale":                       # R5: not bit-inert there
        build(tel).run(rounds=2, log_every=1)
    return state, res, tel.metrics.snapshot()


@pytest.fixture(scope="module")
def reference_runs():
    """Each network's reference run, made once (the shim's lifetime)."""
    with reference_wireless():
        yield {name: _reference_run(name) for name in NETWORKS}


@pytest.mark.parametrize("name", sorted(NETWORKS))
def test_network_mode_matches_reference(reference_runs, name):
    state, want, _ = reference_runs[name]
    pop = Population(64, **POPULATION) if name == "population" else None
    sim = _port_sim(name, pop)
    sim.load_state_dict(state)
    got = sim.run(rounds=2, log_every=1)
    assert got.network == want.network           # same streams, same rows
    assert got.total_sim_time_s == want.total_sim_time_s
    assert len(got.history) == len(want.history) == 2
    for a, b in zip(got.history, want.history):
        assert set(a) == set(b)
        for k in ("round", "mean_participants", "sim_time_s"):
            assert a[k] == b[k], k
        for k in ("train_loss", "test_loss", "test_acc"):
            np.testing.assert_allclose(a[k], b[k], rtol=RTOL, atol=ATOL,
                                       err_msg=k)
    for k in want.global_params:
        for n in want.global_params[k]:
            np.testing.assert_allclose(
                got.global_params[k][n].numpy(),
                np.asarray(want.global_params[k][n]), rtol=RTOL, atol=ATOL,
                err_msg=f"{k}/{n}")
    rows = want.network
    # each network reaches the mode it is here for
    if name == "rayleigh":
        parts = [r["participants"] for r in rows]
        assert 0 in parts and any(0 < p < 4 for p in parts), parts
    elif name == "stale":
        assert any(r["stale_delivered"] > 0 for r in rows), rows
    elif name == "outage":
        assert any(r.get("es_down") and r["participants"] for r in rows)
    else:
        assert all(r["scheduled"] <= 4 for r in rows)
        assert pop.part_count.sum() == 16 and (pop.head_slot >= 0).any()


GAUGES = ("train_loss", "test_loss", "test_acc")


@pytest.mark.parametrize("name", sorted(NETWORKS))
def test_fedsim_instruments_match_reference(reference_runs, name):
    """``FedSim(telemetry=)``'s instruments: the aggregation masses and
    the scheduler's counters equal the reference's exactly, the logged
    losses and accuracy within the no-codec tolerance of the reference's
    telemetry-off run."""
    state, want, want_snap = reference_runs[name]
    pop = Population(64, **POPULATION) if name == "population" else None
    tel = Telemetry()
    sim = _port_sim(name, pop, telemetry=tel)
    sim.load_state_dict(state)
    got = sim.run(rounds=2, log_every=1)
    snap = tel.metrics.snapshot()
    assert set(snap) == set(want_snap)
    assert snap["fedsim.rounds"]["value"] == 2
    assert snap["fedsim.round_wall_s"]["count"] == 2
    for k in set(snap) - {f"fedsim.{g}" for g in GAUGES} - {
            "fedsim.round_wall_s"}:
        assert snap[k] == want_snap[k], k
    for g in GAUGES:
        assert snap[f"fedsim.{g}"]["value"] == got.history[-1][g]
        np.testing.assert_allclose(snap[f"fedsim.{g}"]["value"],
                                   want.history[-1][g], rtol=RTOL,
                                   atol=ATOL, err_msg=g)
    if name == "stale":
        assert snap["fedsim.agg_mass_stale"]["value"] > 0
        assert snap["stale.delivered"]["value"] > 0


def test_save_restore_resumes_bit_identically(tmp_path):
    """Kill after round 1, restore into a fresh simulator, finish: the
    same rows, history and parameters as the uninterrupted run, bit for
    bit (the scheduler's streams, budgets and stale bank are state)."""
    whole = _port_sim("stale").run(rounds=2, log_every=1)
    first = _port_sim("stale")
    first.run(rounds=1, log_every=1)
    first.save(str(tmp_path))
    resumed = _port_sim("stale")
    assert resumed.restore(str(tmp_path / "empty")) is None
    assert resumed.restore(str(tmp_path)) == 1
    assert resumed._stale_params is not None
    res = resumed.run(rounds=2, log_every=1)
    assert res.history == whole.history[1:]
    assert res.network == whole.network[2:]
    for a, b in zip(tree_leaves(res.global_params),
                    tree_leaves(whole.global_params)):
        assert torch.equal(a, b)


def test_population_mode_rejects_what_the_reference_rejects():
    pop = Population(64, num_es=2, seed=0)
    data = make_federated_image_data(4, 0.5, **DATA)

    def build(wireless, population=pop, h=H):
        return FedSim(CNNConfig(**SMALL), data, HierarchyConfig(**h),
                      TrainConfig(**T), wireless=wireless,
                      population=population, device="cpu")

    with pytest.raises(ValueError):                       # no network
        build(None)
    with pytest.raises(ValueError):                       # staleness
        build(WirelessConfig(model="rayleigh", staleness_lambda=0.5))
    with pytest.raises(ValueError):                       # B mismatch
        build(WirelessConfig(model="rayleigh"),
              population=Population(64, num_es=4, seed=0))
