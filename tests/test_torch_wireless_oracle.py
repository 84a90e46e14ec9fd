"""Port parity for the wireless numpy oracle (``repro_torch.wireless``)
against the reference's (``repro.wireless``).

The oracle is numpy on both sides, so the bar is the reference's own:
bit-identical ``RoundReport``s, field by field, over the 20 scheduler
configurations x 6 rounds of ``tests/test_population.py``, and the same
carried state.  A ``state_dict`` crosses between the two packages both
ways and the trajectory continues bit for bit.

The reference's wireless package fails to import on this jax (R1 in
ROADMAP.md: ``scheduler_core`` imports ``jax.experimental.enable_x64``,
which jax 0.9.0 removed).  :func:`reference_wireless` makes it importable
for the length of a fixture only: it sets that attribute through a
``MonkeyPatch``, and on exit drops ``repro.wireless*`` (and
``repro.launch.train``, which imports it) from ``sys.modules``, so every
other test of the worker sees the reference exactly as before.  The
other ``test_torch_*wireless*`` / cohort / comm files import it from here.
"""

import contextlib
import dataclasses
import sys

import numpy as np
import pytest

from repro_torch.configs.base import FaultConfig, WirelessConfig
from repro_torch.configs.phsfl_cnn import CONFIG as CNN_CFG
from repro_torch.core.comm import comm_for_cnn, comm_table_for_cnn
from repro_torch.wireless import make_scheduler
from repro_torch.wireless.scheduler import RoundReport

_DROP = ("repro.wireless", "repro.launch.train")


def _forget_reference_wireless():
    for name in list(sys.modules):
        if any(name == d or name.startswith(d + ".") for d in _DROP):
            del sys.modules[name]
    for pkg, attr in (("repro", "wireless"), ("repro.launch", "train")):
        mod = sys.modules.get(pkg)
        if mod is not None and attr in vars(mod):
            delattr(mod, attr)


@contextlib.contextmanager
def reference_wireless():
    """``repro.wireless`` importable inside the block (the R1 shim), and
    gone again after it.  Inside, the reference's ``CohortScheduler``
    steps through its numpy oracle (``ParticipationScheduler.step``): the
    oracle is the truth, and its jitted float64 core is not run here."""
    import jax
    import jax.experimental
    shimmed = not hasattr(jax.experimental, "enable_x64")
    mp = pytest.MonkeyPatch()
    try:
        if shimmed:
            mp.setattr(jax.experimental, "enable_x64",
                       lambda: jax.enable_x64(True), raising=False)
        import repro.wireless
        from repro.wireless.population import CohortScheduler
        from repro.wireless.scheduler import ParticipationScheduler
        mp.setattr(CohortScheduler, "_step_core",
                   lambda self, r: ParticipationScheduler.step(self, r))
        yield repro.wireless
    finally:
        mp.undo()
        if shimmed:
            _forget_reference_wireless()


@pytest.fixture(scope="module")
def ref():
    with reference_wireless() as w:
        yield w


# ------------------------------------ the configurations of the property --
U = 8
ES2 = np.arange(U) // 4
BASE = dict(mean_uplink_mbps=8.0, mean_downlink_mbps=30.0, latency_s=0.01,
            deadline_s=1.5, energy_budget_j=20.0, tx_power_w=0.7,
            heterogeneity=0.5, seed=3)
TRACE = tuple(tuple(5.0 + 3 * ((i * 7 + j * 3) % 5) for j in range(U))
              for i in range(4))
TRACE_DOWN = tuple(tuple(20.0 + 5 * ((i * 3 + j) % 4) for j in range(U))
                   for i in range(4))
OUTAGE = tuple((0, 1) if i % 3 == 1 else (0, 0) for i in range(6))

# tests/test_population.py's CONFIGS, with FaultConfig as its kwargs so
# either package's class can be built from them
CONFIGS = {
    "static": dict(model="static", **BASE),
    "rayleigh": dict(model="rayleigh", **BASE),
    "trace": dict(model="trace", trace=TRACE, **BASE),
    "trace_down": dict(model="trace", trace=TRACE, trace_down=TRACE_DOWN,
                       **BASE),
    "contend_eq": dict(model="rayleigh", es_uplink_mbps=12.0, **BASE),
    "contend_prop": dict(model="rayleigh", es_uplink_mbps=12.0,
                         contention="proportional", **BASE),
    "contend_noreshare": dict(model="rayleigh", es_uplink_mbps=12.0,
                              contention="proportional",
                              reshare_uplink=False, **BASE),
    "pipeline": dict(model="rayleigh", pipeline=True, **BASE),
    "pipeline_contend": dict(model="rayleigh", pipeline=True,
                             es_uplink_mbps=12.0,
                             contention="proportional", **BASE),
    "greedy_cut": dict(model="rayleigh", cut_policy="greedy",
                       compute_gflops=2.0, compute_heterogeneity=0.4,
                       compute_power_w=0.3, **BASE),
    "deadline_cut": dict(model="rayleigh", cut_policy="deadline",
                         es_uplink_mbps=12.0, contention="proportional",
                         compute_gflops=2.0, compute_power_w=0.3, **BASE),
    "topk": dict(model="rayleigh", selection="topk", topk=3,
                 es_uplink_mbps=10.0, contention="proportional", **BASE),
    "random": dict(model="rayleigh", selection="random",
                   participation_prob=0.6, **BASE),
    "stale": dict(model="rayleigh", staleness_lambda=0.5, **BASE),
    "ideal": dict(model="ideal"),
    "outage_reassoc": dict(model="rayleigh", es_uplink_mbps=12.0,
                           contention="proportional",
                           faults=dict(es_outage_trace=OUTAGE), **BASE),
    "outage_skip": dict(model="rayleigh", es_uplink_mbps=12.0,
                        faults=dict(es_outage_trace=OUTAGE,
                                    failover="skip"), **BASE),
    "harq": dict(model="rayleigh",
                 faults=dict(erasure_prob=0.3, max_retries=2,
                             backoff_s=0.02), **BASE),
    "crash": dict(model="rayleigh", faults=dict(crash_hazard=0.3), **BASE),
    "harq_outage_stale": dict(model="rayleigh", staleness_lambda=0.5,
                              es_uplink_mbps=12.0,
                              faults=dict(erasure_prob=0.25, max_retries=2,
                                          backoff_s=0.02,
                                          es_outage_trace=OUTAGE),
                              **BASE),
}
TABLE = {"greedy_cut", "deadline_cut"}
TWO_ES = {"contend_eq", "contend_prop", "contend_noreshare",
          "pipeline_contend", "deadline_cut", "topk", "outage_reassoc",
          "outage_skip", "harq_outage_stale"}


def wireless_config(name, wireless_cls=WirelessConfig,
                    fault_cls=FaultConfig):
    kw = dict(CONFIGS[name])
    if "faults" in kw:
        kw["faults"] = fault_cls(**kw["faults"])
    return wireless_cls(**kw)


def port_scheduler(name, **extra):
    """The port's scheduler of config ``name`` (``extra`` reaches
    ``make_scheduler``: ``cls=CohortScheduler, core_device=...``)."""
    wcfg = wireless_config(name)
    es = ES2 if name in TWO_ES else None
    kw = dict(dataset_size=400, batch_size=16)
    if name in TABLE:
        return make_scheduler(wcfg, U, kappa0=2,
                              comm_table=comm_table_for_cnn(CNN_CFG, **kw),
                              es_assign=es, **extra)
    return make_scheduler(wcfg, U, comm_for_cnn(CNN_CFG, **kw), 2,
                          es_assign=es, **extra)


def reference_scheduler(ref, name):
    from repro.configs.base import FaultConfig as JF, WirelessConfig as JW
    from repro.configs.phsfl_cnn import CONFIG as JCNN
    from repro.core.comm import comm_for_cnn as jcomm
    from repro.core.comm import comm_table_for_cnn as jtable
    wcfg = wireless_config(name, JW, JF)
    es = ES2 if name in TWO_ES else None
    kw = dict(dataset_size=400, batch_size=16)
    if name in TABLE:
        return ref.make_scheduler(wcfg, U, kappa0=2,
                                  comm_table=jtable(JCNN, **kw),
                                  es_assign=es)
    return ref.make_scheduler(wcfg, U, jcomm(JCNN, **kw), 2, es_assign=es)


def assert_reports_equal(ra, rb, tag=""):
    """tests/test_population.py's field-by-field bar."""
    for f in dataclasses.fields(RoundReport):
        va, vb = getattr(ra, f.name), getattr(rb, f.name)
        if isinstance(va, np.ndarray) or isinstance(vb, np.ndarray):
            assert (va is None) == (vb is None), (tag, f.name)
            assert np.array_equal(np.asarray(va), np.asarray(vb)), \
                (tag, f.name, va, vb)
        else:
            assert va == vb, (tag, f.name, va, vb)


CARRIED = ("energy_left", "_stale_pending", "_stale_age")


# ------------------------------------------------------------ the bar -----
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_port_oracle_matches_reference_oracle(ref, name):
    want, got = reference_scheduler(ref, name), port_scheduler(name)
    assert type(got).__name__ == "ParticipationScheduler"
    for r in range(6):
        assert_reports_equal(got.step(r), want.step(r), f"{name} r{r}")
    for attr in CARRIED:
        assert np.array_equal(getattr(got, attr), getattr(want, attr)), \
            (name, attr)


@pytest.mark.parametrize("name", ["contend_prop", "harq_outage_stale"])
def test_state_dict_crosses_both_ways(ref, name):
    """After 3 rounds the two state dicts hold the same keys and arrays;
    each side resumes from the other's and both continue in lockstep."""
    want, got = reference_scheduler(ref, name), port_scheduler(name)
    for r in range(3):
        want.step(r)
        got.step(r)
    sw, sg = want.state_dict(), got.state_dict()
    assert sorted(sw) == sorted(sg)
    for k in sw:
        assert sw[k].dtype == sg[k].dtype and np.array_equal(sw[k], sg[k]), k
    port_from_ref = port_scheduler(name)
    port_from_ref.load_state_dict(sw)
    ref_from_port = reference_scheduler(ref, name)
    ref_from_port.load_state_dict(sg)
    for r in range(3, 6):
        rep = want.step(r)
        assert_reports_equal(port_from_ref.step(r), rep, f"{name} r{r}")
        assert_reports_equal(ref_from_port.step(r), rep, f"{name} r{r}")


def test_report_json_round_trip():
    sched = port_scheduler("harq_outage_stale")
    for r in range(3):
        rep = sched.step(r)
        back = RoundReport.from_json_dict(rep.to_json_dict())
        assert_reports_equal(back, rep, f"r{r}")


def test_fault_free_default_builds_no_injector():
    assert not FaultConfig().active
    assert port_scheduler("rayleigh").injector is None
    assert port_scheduler("harq").injector is not None

