"""Port parity for the telemetry registry, sinks and manifest
(``repro_torch.telemetry``) against the reference's ``repro.telemetry``.

``repro.telemetry`` imports neither jax nor ``repro.wireless``, so it is
imported directly.  The same sequence of counter, gauge and histogram
operations on both registries gives equal snapshots, byte-identical JSONL
lines and an identical summary table; the ``MetricLogger`` mirror, the
shim and ``config_hash`` behave as the reference's.
"""

import dataclasses
import io
import json

import numpy as np
import pytest

import repro.telemetry as ref
import repro_torch.telemetry as port

# (kind, name, value or histogram buckets): one script for both registries
OPS = [
    ("counter", "sched.bits_moved", 7),
    ("counter", "sched.bits_moved", 2.5e8),
    ("counter", "energy.tx_j", 0.1),
    ("counter", "energy.tx_j", 0.2),
    ("gauge", "fedsim.test_acc", 0.5),
    ("gauge", "fedsim.test_acc", np.float32(0.1234567)),
    ("gauge", "stale.bank_depth", 3),
    ("histogram", "sched.round_time_s", 0.0),
    ("histogram", "sched.round_time_s", 1e-4),
    ("histogram", "sched.round_time_s", 0.3),
    ("histogram", "sched.round_time_s", 1.0),
    ("histogram", "sched.round_time_s", 250.0),
    ("histogram", "kernel.quantize.wall_s", 0.0021),
    ("custom", "h.custom", 3.0),
    ("custom", "h.custom", 0.5),
    ("empty", "h.empty", None),
]


def _drive(mod):
    reg = mod.MetricsRegistry()
    for kind, name, v in OPS:
        if kind == "counter":
            reg.counter(name).inc(v)
        elif kind == "gauge":
            reg.gauge(name).set(v)
        elif kind == "histogram":
            reg.histogram(name).observe(v)
        elif kind == "custom":
            reg.histogram(name, buckets=(1.0, 2.0)).observe(v)
        else:
            reg.histogram(name)
    return reg


def test_registry_snapshot_jsonl_and_summary_match_reference():
    a, b = _drive(port), _drive(ref)
    assert a.snapshot() == b.snapshot()
    fa, fb = io.StringIO(), io.StringIO()
    assert a.flush_jsonl(fa, step=3) == b.flush_jsonl(fb, step=3)
    a.flush_jsonl(fa, step=None)
    b.flush_jsonl(fb, step=None)
    assert fa.getvalue() == fb.getvalue()
    assert a.summary_table() == b.summary_table()
    assert port.Histogram.DEFAULT_BOUNDS == ref.Histogram.DEFAULT_BOUNDS


@pytest.mark.parametrize("kind", ["counter", "gauge", "histogram"])
def test_registry_errors_match_reference(kind):
    for mod in (port, ref):
        reg = mod.MetricsRegistry()
        getattr(reg, kind)("x")
        other = "gauge" if kind == "counter" else "counter"
        with pytest.raises(TypeError):
            getattr(reg, other)("x")
        with pytest.raises(ValueError):
            mod.Counter("c").inc(-1)
        with pytest.raises(ValueError):
            mod.Histogram("h", buckets=(2.0, 1.0))


def test_metric_logger_mirror_and_json_safe_match_reference():
    records = []
    for mod in (port, ref):
        tel = mod.Telemetry()                 # enabled, in memory
        out = io.StringIO()
        log = mod.MetricLogger("t", stream=out, telemetry=tel)
        rec = log.log(step=2, loss=np.float32(2.5), n=3, ok=True,
                      xs=[1, 2], name="adam", arr=np.arange(2))
        rec.pop("t")
        line = json.loads(out.getvalue().split("] ", 1)[1])
        line.pop("t")
        snap = tel.metrics.snapshot()
        records.append((rec, line, snap))
        assert "log.t.name" not in snap and "log.t.xs" not in snap
        assert snap["log.t.loss"]["value"] == 2.5
        assert snap["log.t.ok"]["value"] == 1.0
        off = io.StringIO()
        mod.MetricLogger("t", stream=off,
                         telemetry=mod.Telemetry.disabled()).log(loss=1.0)
        assert mod.Telemetry.disabled().metrics.names() == []
    assert records[0] == records[1]
    for v in (None, 1, 2.5, "s", np.int64(2), np.float32(0.5), np.arange(3),
              {"k": (1, np.int64(2))}, [np.bool_(True)], object):
        got, want = port.json_safe(v), ref.json_safe(v)
        if v is object:
            assert got.startswith("<class") and want.startswith("<class")
        else:
            assert got == want and type(got) is type(want), v


def test_logging_shim_reexports_the_sink():
    from repro_torch.utils.logging import MetricLogger, json_safe
    assert MetricLogger is port.MetricLogger
    assert json_safe is port.json_safe


def test_config_hash_matches_reference_on_equal_configs():
    from repro.configs.base import FaultConfig as JF
    from repro.configs.base import WirelessConfig as JW
    from repro.configs.sweeps import sweep_hierarchy as j_hier
    from repro.configs.sweeps import sweep_train as j_train
    from repro_torch.configs import (FaultConfig, WirelessConfig,
                                     sweep_hierarchy, sweep_train)
    pairs = [(WirelessConfig(model="static"), JW(model="static")),
             (WirelessConfig(model="rayleigh", deadline_s=0.3,
                             faults=FaultConfig(erasure_prob=0.3)),
              JW(model="rayleigh", deadline_s=0.3,
                 faults=JF(erasure_prob=0.3))),
             (sweep_hierarchy(2), j_hier(2)), (sweep_train(), j_train())]
    for a, b in pairs:
        assert repr(a) == repr(b)
        assert port.config_hash(a) == ref.config_hash(b)
    assert port.config_hash(pairs[0][0]) != port.config_hash(pairs[1][0])
    d = {"rounds": 2, "channel": "rayleigh", "deadline": float("inf")}
    assert port.config_hash(d) == ref.config_hash(d)
    assert port.config_hash(None) is ref.config_hash(None) is None


def test_manifest_keys_match_reference_with_torch_for_jax(tmp_path):
    a = port.collect_manifest(config={"a": 1}, seeds={"seed": 7},
                              extra={"note": "x"})
    b = ref.collect_manifest(config={"a": 1}, seeds={"seed": 7},
                             extra={"note": "x"})
    assert set(a) - {"torch"} == set(b) - {"jax"}
    assert {k: a[k] for k in ("config_hash", "config_repr", "seeds", "note",
                              "python", "git_sha")} == {
        k: b[k] for k in ("config_hash", "config_repr", "seeds", "note",
                          "python", "git_sha")}
    info = a["torch"]
    assert set(info) == {"version", "cuda", "backend", "device_kind",
                         "device_count"}
    import torch
    assert info["version"] == torch.__version__
    assert info["backend"] == ("cuda" if torch.cuda.is_available()
                               else "cpu")
    path = port.write_manifest(str(tmp_path / "m.json"), a)
    assert json.load(open(path))["seeds"] == {"seed": 7}


def test_telemetry_handle_files_and_off_state(tmp_path):
    tel = port.Telemetry(str(tmp_path), metrics_every=2, kernels=True)
    assert port.get_kernel_sink() is tel.metrics
    for step in range(3):
        tel.metrics.counter("c").inc()
        tel.flush(step=step)
    tel.write_manifest(config={"x": 1}, seeds={"seed": 0})
    table = tel.close()
    assert port.get_kernel_sink() is None
    assert tel.close() == table                   # idempotent
    lines = [json.loads(ln) for ln in open(tmp_path / "metrics.jsonl")]
    assert [ln["step"] for ln in lines] == [0, 2, None]
    assert (tmp_path / "summary.txt").read_text() == table + "\n"
    assert json.load(open(tmp_path / "trace.json")) == [
        {"args": {"name": "round markers"}, "name": "process_name",
         "ph": "M", "pid": 0}]
    assert json.load(open(tmp_path / "manifest.json"))["seeds"] == {
        "seed": 0}
    off = port.Telemetry.disabled()
    assert off is port.Telemetry.disabled() and not off.enabled
    assert off.record_round(None, None) is None
    assert off.close() is None and off.write_manifest(config={}) is None


def test_sweeps_match_reference_field_for_field():
    from repro.configs import sweeps as j
    from repro_torch.configs import sweeps as p
    for a, b in ((p.sweep_hierarchy(3, kappa0=4), j.sweep_hierarchy(
            3, kappa0=4)), (p.sweep_train(), j.sweep_train()),
            (p.sweep_wireless("static", deadline_s=3.0, pipeline=True),
             j.sweep_wireless("static", deadline_s=3.0, pipeline=True))):
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
