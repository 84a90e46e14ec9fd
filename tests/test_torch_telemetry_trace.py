"""Port parity for the trace export and the schedulers' telemetry hooks
(``repro_torch.telemetry.trace``, ``ParticipationScheduler(telemetry=)``,
``CohortScheduler(telemetry=)``) against the reference's.

- The reference's hand-computed two-client pipelined fault round
  (``tests/test_telemetry.py``: one HARQ retransmission, one crash), built
  with each package's own ``build_timeline``, exports equal event lists,
  with the hand-derived microsecond stamps.
- A real fault-injected pipelined scheduler run with
  ``make_scheduler(..., telemetry=Telemetry(dir))``: the streamed
  ``trace.json`` equals the reference's event for event, every client
  segment's ``ts``/``dur`` equals the port's ``last_timeline`` as an exact
  float, and ``metrics.jsonl`` equals the reference's line for line.
- A ``CohortScheduler`` round (the port's core on the CPU) records the
  reference's trace and metrics; with telemetry off ``last_timeline``
  stays None and the reports are unchanged.

The reference's ``repro.wireless`` is importable only under
``reference_wireless()`` (R1), inside each test.
"""

import json
import math

import numpy as np

from test_torch_wireless_oracle import (assert_reports_equal,
                                        reference_wireless)

import repro_torch.telemetry as port_tel
from repro_torch.configs.base import FaultConfig, WirelessConfig
from repro_torch.configs.phsfl_cnn import CONFIG as CNN_CFG
from repro_torch.core.comm import comm_for_cnn
from repro_torch.wireless import make_scheduler
from repro_torch.wireless.channel import LinkState, RoundBits
from repro_torch.wireless.faults import FaultPlan
from repro_torch.wireless.population import (Population,
                                             make_cohort_scheduler)
from repro_torch.wireless.timeline import build_timeline

US = 1e6


def _hand_round(link_cls, bits_cls, plan_cls, build):
    """tests/test_telemetry.py's round: up 100 bps, down 200 bps, compute
    2 s in 2 chunks, payloads of 100 bits, a 50-bit tail, 100 bits down,
    backoff 0.25 s; client 0 retransmits payload 1 once, client 1 crashes
    at 3.5 s."""
    U = 2
    link = link_cls(uplink_bps=np.full(U, 100.0),
                    downlink_bps=np.full(U, 200.0), latency_s=np.zeros(U))
    bits = bits_cls(uplink=250.0, downlink=100.0, up_stream=100.0,
                    up_tail=50.0, chunks=2)
    plan = plan_cls(up_attempts=np.array([[1, 2, 1], [1, 1, 1]]),
                    up_ok=np.ones((2, 3), bool),
                    down_attempts=np.array([1, 1]),
                    down_ok=np.array([True, True]),
                    crash_frac=np.array([np.inf, 0.35]), backoff_s=0.25)
    return build(link, bits, np.full(U, 2.0), 10.0, U, plan=plan,
                 pipeline=True)


def test_hand_computed_fault_round_exports_the_reference_events():
    with reference_wireless():
        from repro.telemetry import timeline_to_trace_events as ref_export
        from repro.wireless.channel import LinkState as JL
        from repro.wireless.channel import RoundBits as JB
        from repro.wireless.faults import FaultPlan as JP
        from repro.wireless.timeline import build_timeline as j_build
        ref_tl = _hand_round(JL, JB, JP, j_build)
        want = ref_export(ref_tl, round_idx=7, t0_s=100.0)
        want_masked = ref_export(ref_tl, 0, clients=[True, False])
    tl = _hand_round(LinkState, RoundBits, FaultPlan, build_timeline)
    evs = port_tel.timeline_to_trace_events(tl, round_idx=7, t0_s=100.0)
    assert evs == want
    assert port_tel.timeline_to_trace_events(
        tl, 0, clients=[True, False]) == want_masked

    def seg(u, name):
        (e,) = [e for e in evs if e["tid"] == u and e["name"] == name]
        return e

    assert seg(0, "compute[1]")["ts"] == 101.0 * US
    retx = seg(0, "uplink[p1.a1]")      # backoff 0.25 after p1 ends at 3
    assert retx["ts"] == 103.25 * US and retx["dur"] == 1.0 * US
    assert retx["args"] == {"round": 7, "bits": 100.0, "payload": 1,
                            "attempt": 1, "retx": True}
    assert seg(0, "downlink")["ts"] == 104.75 * US
    crash = seg(1, "crash")
    assert crash["ph"] == "i" and crash["ts"] == 103.5 * US
    assert len([e for e in evs if e["tid"] == 0]) == 7
    assert len([e for e in evs if e["tid"] == 1]) == 7


FAULT_NET = dict(model="static", mean_uplink_mbps=20.0,
                 mean_downlink_mbps=80.0, deadline_s=3.0, pipeline=True,
                 staleness_lambda=0.5, seed=0)
FAULTS = dict(erasure_prob=0.4, max_retries=2, backoff_s=0.1,
              crash_hazard=0.2)
COMM = dict(dataset_size=400, batch_size=16, batches_per_epoch=2)
ROUNDS = 4


def _fault_run(pkg, out_dir, U=4):
    """tests/test_telemetry.py's fault-injected pipelined scheduler, with
    telemetry recording into ``out_dir``; returns each round's (clock at
    its start, report, timeline)."""
    if pkg == "port":
        cfg = WirelessConfig(faults=FaultConfig(**FAULTS), **FAULT_NET)
        comm = comm_for_cnn(CNN_CFG, **COMM)
        tel = port_tel.Telemetry(str(out_dir))
        sched = make_scheduler(cfg, U, comm, 2, es_assign=np.arange(U) // 2,
                               telemetry=tel)
    else:
        from repro.configs.base import FaultConfig as JF
        from repro.configs.base import WirelessConfig as JW
        from repro.configs.phsfl_cnn import CONFIG as J_CNN
        from repro.core.comm import comm_for_cnn as j_comm
        from repro.telemetry import Telemetry
        from repro.wireless import make_scheduler as j_make
        cfg = JW(faults=JF(**FAULTS), **FAULT_NET)
        tel = Telemetry(str(out_dir))
        sched = j_make(cfg, U, j_comm(J_CNN, **COMM), 2,
                       es_assign=np.arange(U) // 2, telemetry=tel)
    rounds = []
    for r in range(ROUNDS):
        t0 = tel.trace.clock_s
        rep = sched.step(r)
        rounds.append((t0, rep, sched.last_timeline))
    tel.close()
    return rounds


def _read(out_dir):
    evs = json.load(open(out_dir / "trace.json"))
    lines = [json.loads(ln) for ln in open(out_dir / "metrics.jsonl")]
    return evs, lines


def test_streamed_fault_run_matches_reference_and_its_timeline(tmp_path):
    with reference_wireless():
        _fault_run("ref", tmp_path / "ref")
    rounds = _fault_run("port", tmp_path / "port")
    evs, lines = _read(tmp_path / "port")
    want_evs, want_lines = _read(tmp_path / "ref")
    assert evs == want_evs                        # event for event, exact
    assert lines == want_lines                    # exact floats
    assert len(lines) == ROUNDS + 1               # a flush a round + close
    assert any(".a1]" in e["name"] for e in evs), "no retx in scenario"
    assert lines[-1]["metrics"]["sched.rounds"]["value"] == ROUNDS
    for t0, rep, tl in rounds:
        r = int(rep.round_idx)
        mine = [e for e in evs if e.get("ph") == "X" and e["pid"] == 1
                and e["args"]["round"] == r]
        for u in np.flatnonzero(rep.scheduled):
            got = sorted((e["ts"], e["dur"]) for e in mine
                         if e["tid"] == u and "uplink" in e["name"])
            want = sorted(
                ((t0 + float(s)) * US, float(e - s) * US)
                for s, e, b in zip(tl.tx_start[u], tl.tx_end[u],
                                   tl.tx_bits[u])
                if b > 0 and math.isfinite(s) and math.isfinite(e))
            assert got == want, (r, u)
        if rep.crashed is not None:
            for u in np.flatnonzero(rep.crashed):
                (cr,) = [e for e in evs if e["name"] == "crash"
                         and e.get("tid") == u and e["args"]["round"] == r]
                assert cr["ts"] == (t0 + float(tl.cap_s[u])) * US
    # valid as a JSON array without its closing bracket
    text = (tmp_path / "port" / "trace.json").read_text()
    assert json.loads(text.rstrip().rstrip("]").rstrip() + "]") == evs


COHORT_NET = dict(model="rayleigh", mean_uplink_mbps=8.0,
                  mean_downlink_mbps=30.0, latency_s=0.01, deadline_s=1.5,
                  energy_budget_j=20.0, tx_power_w=0.7, heterogeneity=0.5,
                  es_uplink_mbps=24.0, contention="proportional",
                  pipeline=True, seed=3)
COHORT_N, COHORT_SIZE = 16, 4


def _cohort_run(pkg, telemetry=None):
    if pkg == "port":
        comm = comm_for_cnn(CNN_CFG, **COMM)
        pop = Population(COHORT_N, num_es=2, seed=0)
        sched = make_cohort_scheduler(
            WirelessConfig(**COHORT_NET), COHORT_N, comm, 2, population=pop,
            cohort_size=COHORT_SIZE, es_balanced=True, core_device="cpu",
            telemetry=telemetry)
    else:
        from repro.configs.base import WirelessConfig as JW
        from repro.configs.phsfl_cnn import CONFIG as J_CNN
        from repro.core.comm import comm_for_cnn as j_comm
        from repro.wireless.population import Population as JPop
        from repro.wireless.population import make_cohort_scheduler as j_mk
        pop = JPop(COHORT_N, num_es=2, seed=0)
        sched = j_mk(JW(**COHORT_NET), COHORT_N, j_comm(J_CNN, **COMM), 2,
                     population=pop, cohort_size=COHORT_SIZE,
                     es_balanced=True, telemetry=telemetry)
    reps = [sched.step(r) for r in range(3)]
    return sched, reps


def test_cohort_round_records_the_reference_trace_and_metrics(tmp_path):
    with reference_wireless():
        from repro.telemetry import Telemetry
        ref_tel = Telemetry(str(tmp_path / "ref"))
        _cohort_run("ref", ref_tel)
        ref_tel.close()
    tel = port_tel.Telemetry(str(tmp_path / "port"))
    sched, reps = _cohort_run("port", tel)
    tel.close()
    assert sched.last_timeline is not None
    evs, lines = _read(tmp_path / "port")
    want_evs, want_lines = _read(tmp_path / "ref")
    assert evs == want_evs
    assert lines == want_lines
    assert lines[-1]["metrics"]["sched.scheduled"]["value"] > 0
    off, off_reps = _cohort_run("port", None)
    assert off.last_timeline is None
    for r, (a, b) in enumerate(zip(reps, off_reps)):
        assert_reports_equal(a, b, f"r{r}")


def test_scheduler_results_identical_with_telemetry(tmp_path):
    a = _fault_run("port", tmp_path / "a")
    cfg = WirelessConfig(faults=FaultConfig(**FAULTS), **FAULT_NET)
    plain = make_scheduler(cfg, 4, comm_for_cnn(CNN_CFG, **COMM), 2,
                           es_assign=np.arange(4) // 2)
    for r, (_, rep, _) in enumerate(a):
        assert_reports_equal(rep, plain.step(r), f"r{r}")
    assert np.array_equal(plain.energy_left, a[-1][1].energy_left_j)
