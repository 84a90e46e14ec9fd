"""The four metrics that read the port's spans, fed a recorder filled by
hand: the spans opened and closed as the program opens them, then given
stream intervals (the CPU records no CUDA events) and a device trace
busy for the first BUSY of each span."""

import pytest

from phsfl_bench import harness
from phsfl_bench import spans as bench_spans
from repro_torch.telemetry import spans

UNITS, STEPS, LAYERS = 3, 4, 2
BUSY = 0.75                     # the device's busy share of each span
ANCHOR_US = 1.7e15              # the stream anchor on the Unix clock
# stream ms of one span of each name
MS = {"moe.ffn": 3.0, "moe.ffn.backward": 5.0, "lm_loss": 1.5,
      "lm_loss.backward": 2.5, "phsfl.edge": 7.0, "phsfl.global": 4.0,
      "personalize.head_step": 12.0}


def _reader(name):
    return harness.load_module(harness.BENCH / "metrics" / f"{name}.py",
                               f"phsfl_bench.metrics.{name}")


@pytest.fixture(autouse=True)
def _clean():
    spans.clear()
    yield
    spans.clear()


def _span(name, inside=()):
    sp = spans.open(name)
    for child in inside:
        child()
    spans.close(sp)


def _rounds(recompute: bool = False):
    for _ in range(UNITS):
        def step():
            def ffn():
                _span("moe.ffn", [lambda: _span("moe.route")])
            _span("phsfl.local_step", [
                lambda: _span("phsfl.forward",
                              [ffn] * LAYERS + [lambda: _span("lm_loss")]),
                lambda: _span("phsfl.backward", [lambda: _span(
                    "lm_loss.backward")] + [lambda: _span(
                        "moe.ffn.backward",
                        [ffn] if recompute else [])] * LAYERS)])
        _span("phsfl.round", [step] * STEPS + [
            lambda: _span("phsfl.edge"), lambda: _span("phsfl.global")])


def _banks():
    for _ in range(UNITS):
        _span("personalize.bank", [lambda: _span("personalize.trunk")]
              + [lambda: _span("personalize.head_step",
                               [lambda: _span("lm_loss")])] * STEPS)


def _stream(fill: bool = True) -> list:
    """Give every closed span a stream interval, MS of its name, one after
    another; the device trace: busy for the first BUSY of each, in two
    overlapping kernels."""
    t, device = 0.0, []
    for s in spans.finished():
        if fill:
            ms = MS.get(s.name, 1.0)
            s.anchor_ns, s.stream = ANCHOR_US * 1e3, (t, t + ms)
            at = ANCHOR_US + t * 1e3
            device += [(at, at + BUSY * ms * 1e3, "k"),
                       (at, at + BUSY * ms * 0.5e3, "k.overlap")]
            t += ms
    return sorted(device)


def _ctx(kind, device=()):
    return {"kind": kind, "traced_units": UNITS,
            "trace": {"device": list(device)}}


def test_round_metrics():
    _rounds()
    ctx = _ctx("phsfl_round", _stream())
    per_step = BUSY * LAYERS * (MS["moe.ffn"] + MS["moe.ffn.backward"])
    assert _reader("moe_ffn_ms_per_step").read(ctx) == pytest.approx(
        per_step)
    assert _reader("lm_loss_ms_per_step").read(ctx) == pytest.approx(
        BUSY * (MS["lm_loss"] + MS["lm_loss.backward"]))
    assert _reader("aggregation_ms_per_round").read(ctx) == pytest.approx(
        BUSY * (MS["phsfl.edge"] + MS["phsfl.global"]))
    assert _reader("head_step_ms.personalize").read(ctx) is None


def test_a_forward_recomputed_in_its_backward_counts_once():
    _rounds(recompute=True)
    # the recomputed forward's own interval lies inside its backward's
    device = _stream()
    by_id = {s.id: s for s in spans.finished()}
    for s in spans.finished():
        if s.name == "moe.ffn" and by_id[s.parent].name == "moe.ffn.backward":
            s.stream = by_id[s.parent].stream
    assert _reader("moe_ffn_ms_per_step").read(
        _ctx("phsfl_round", device)) == pytest.approx(
            BUSY * LAYERS * (MS["moe.ffn"] + MS["moe.ffn.backward"]))


def test_bank_metric():
    _banks()
    ctx = _ctx("head_bank", _stream())
    assert _reader("head_step_ms.personalize").read(ctx) == pytest.approx(
        BUSY * MS["personalize.head_step"])
    assert _reader("lm_loss_ms_per_step").read(ctx) is None


@pytest.mark.parametrize("name", ["moe_ffn_ms_per_step",
                                  "lm_loss_ms_per_step",
                                  "aggregation_ms_per_round"])
def test_nothing_to_read(name):
    _rounds()
    _stream(fill=False)                   # the CPU: no stream times
    assert _reader(name).read(_ctx("phsfl_round")) is None
    spans.clear()                         # no spans at all
    assert _reader(name).read(_ctx("phsfl_round")) is None


def test_a_unit_count_that_is_not_the_traced_units_raises():
    _rounds()
    ctx = dict(_ctx("phsfl_round", _stream()), traced_units=UNITS + 1)
    with pytest.raises(ValueError):
        _reader("aggregation_ms_per_round").read(ctx)


def test_busy_time_is_the_union_clipped_to_the_interval():
    merged = bench_spans.union([(9.0, 12.0, "c"), (0.0, 4.0, "a"),
                                (2.0, 6.0, "b"), (20.0, 21.0, "d")])
    assert merged == ([0.0, 9.0, 20.0], [6.0, 12.0, 21.0])
    assert bench_spans.busy_us(merged, 3.0, 10.0) == pytest.approx(4.0)
    assert bench_spans.busy_us(merged, -5.0, 30.0) == pytest.approx(10.0)
    assert bench_spans.busy_us(merged, 6.0, 9.0) == 0.0
    assert bench_spans.busy_us(merged, 11.5, 20.5) == pytest.approx(1.0)
