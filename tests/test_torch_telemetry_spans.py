"""The port's program spans (``repro_torch.telemetry.spans``) on the CPU:
off they record nothing and add no autograd node; on, a tiny olmoe host
round and a tiny head bank compute the same numbers bit for bit; the
names, parents, args and self times; the backward spans after their
forward spans and inside ``phsfl.backward``; under a CPU-only torch
profiler every span is a host event that is not a user annotation,
bracketed by its ``time.time_ns()`` stamps; a ``Telemetry`` handle's
``spans.json`` and ``span.*`` histograms, and ``tools/port_check_spans.py``
on them; the recorder's bounds with no handle on.  The CPU has no CUDA events: stream times are the card's."""

import dataclasses
import json
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs.base import HierarchyConfig, TrainConfig
from repro_torch.configs.registry import get_arch
from repro_torch.core.personalize import personalize_head_bank
from repro_torch.core.phsfl import (build_optimizer, make_host_round,
                                    stack_replicas)
from repro_torch.models.registry import build_model
from repro_torch.telemetry import Telemetry, spans
from repro_torch.utils.tree import tree_leaves
from tools import port_check_spans

CLIENTS, KAPPA0, LAYERS = 2, 2, 2
MARKS = ("_InputMarkBackward", "_OutputMarkBackward")


@pytest.fixture(autouse=True)
def _recorder_off(monkeypatch):
    """Each test starts with no handle on, no profiler, no spans."""
    monkeypatch.setattr(spans, "_handles", 0)
    spans.clear()
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    spans.clear()
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def olmoe():
    cfg = get_arch("olmoe-1b-7b").reduced(num_layers=LAYERS, max_experts=4)
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                           top_k=2))
    model = build_model(cfg)
    return model, model.init(torch.Generator().manual_seed(0))


def _round(model, one):
    tcfg = TrainConfig(learning_rate=1.0, remat=False,
                       local_steps_in_step=KAPPA0)
    hcfg = HierarchyConfig(num_edge_servers=2, clients_per_es=CLIENTS // 2,
                           kappa0=KAPPA0, kappa1=1)
    opt, _ = build_optimizer(model, tcfg, params=one)
    rnd = make_host_round(model, hcfg, tcfg, num_clients=CLIENTS,
                          global_sync=True)
    tok = torch.randint(0, model.cfg.vocab_size, (CLIENTS, KAPPA0, 2, 32),
                        generator=torch.Generator().manual_seed(1))
    p, s, m = rnd.fn(stack_replicas(one, CLIENTS),
                     stack_replicas(opt.init(one), CLIENTS),
                     {"tokens": tok, "labels": tok},
                     torch.full((CLIENTS,), 1.0),
                     torch.full((CLIENTS,), 1.0 / 2))
    return tree_leaves(p) + tree_leaves(s) + [m["loss"]]


def _bank(model, one):
    tok = torch.randint(0, model.cfg.vocab_size, (3, 2, 32),
                        generator=torch.Generator().manual_seed(2))
    bank, losses = personalize_head_bank(
        model, one, {"tokens": tok, "labels": tok},
        TrainConfig(finetune_steps=2, finetune_lr=1.0))
    return [bank, losses]


def _nodes(t):
    seen, todo = set(), [t.grad_fn]
    while todo:
        f = todo.pop()
        if f is None or f in seen:
            continue
        seen.add(f)
        todo += [g for g, _ in f.next_functions]
    return {type(f).__name__ for f in seen}


def _loss(model, one):
    tok = torch.randint(0, model.cfg.vocab_size, (2, 32),
                        generator=torch.Generator().manual_seed(3))
    leaves = {k: v for k, v in one.items()}
    p = torch.utils._pytree.tree_map(
        lambda x: x.detach().requires_grad_(True), leaves)
    return model.loss(p, {"tokens": tok, "labels": tok})


def test_off_records_nothing_and_adds_no_autograd_node(olmoe):
    assert not spans.on()
    loss = _loss(*olmoe)
    assert not _nodes(loss) & set(MARKS)
    _round(*olmoe)
    assert spans.finished() == [] and spans.RECORDER.stack == []
    spans.attach()                       # the same loss, on: both markers
    try:
        assert set(MARKS) <= _nodes(_loss(*olmoe))
    finally:
        spans.detach()


@pytest.mark.parametrize("run", [_round, _bank], ids=["round", "bank"])
def test_on_is_bit_identical_to_off(olmoe, run):
    off = run(*olmoe)
    spans.attach()
    try:
        on = run(*olmoe)
    finally:
        spans.detach()
    assert spans.finished()
    assert len(on) == len(off)
    for a, b in zip(on, off):
        assert a.dtype == b.dtype and torch.equal(a, b)


def _tree(got):
    kids = {}
    for s in got:
        kids.setdefault(s.parent, []).append(s)
    for v in kids.values():
        v.sort(key=lambda s: s.start_ns)
    return kids


def _recorded_round(olmoe):
    spans.attach()
    try:
        _round(*olmoe)
    finally:
        spans.detach()
    return spans.take()


def test_names_parents_args_and_self_time(olmoe):
    got = _recorded_round(olmoe)
    kids = _tree(got)
    (rnd,) = kids[None]
    assert rnd.name == "phsfl.round"
    assert rnd.args == {"clients": CLIENTS, "round": 0}
    under = [s.name for s in kids[rnd.id]]
    assert under == ["phsfl.local_step"] * (CLIENTS * KAPPA0) + [
        "phsfl.edge", "phsfl.global"]
    n_leaves = len(tree_leaves(olmoe[1]))
    for agg in kids[rnd.id][-2:]:
        assert agg.args["leaves"] == n_leaves and agg.args["bytes"] > 0
    for i, step in enumerate(kids[rnd.id][:-2]):
        assert step.args == {"client": i // KAPPA0, "step": i % KAPPA0,
                             "tokens": 2 * 32}
        fwd, bwd, upd = kids[step.id]
        assert [fwd.name, bwd.name, upd.name] == [
            "phsfl.forward", "phsfl.backward", "phsfl.update"]
        ffns = [s for s in kids[fwd.id] if s.name == "moe.ffn"]
        assert [s.args["layer"] for s in ffns] == list(range(LAYERS))
        assert [s.name for s in kids[fwd.id]][-1] == "lm_loss"
        for f in ffns:
            assert f.args["pairs"] == 2 * 32 * 2          # tokens x top-2
            assert [s.name for s in kids[f.id]] == [
                "moe.route", "moe.dispatch", "moe.experts", "moe.combine"]
        # self time: the span less its children, which do not overlap
        want = (step.end_ns - step.start_ns - sum(
            s.end_ns - s.start_ns for s in (fwd, bwd, upd))) / 1e9
        assert spans.self_time(step, got) == pytest.approx(want, abs=1e-9)
    assert all(s.stream is None for s in got)     # no CUDA events here


def test_self_time_of_overlapping_children():
    spans.attach()
    try:
        top = spans.open("top")
        time.sleep(0.002)
        a = spans.open("a")
        time.sleep(0.002)
        b = spans.open("b")               # inside a: a grandchild of top
        time.sleep(0.002)
        spans.close(b)
        spans.close(a)
        time.sleep(0.002)
        spans.close(top)
    finally:
        spans.detach()
    got = spans.take()
    assert (top.index, a.parent, b.parent) == (0, top.id, a.id)
    assert spans.self_time(top, got) == pytest.approx(
        top.host_s - a.host_s, abs=1e-9)
    assert spans.self_time(a, got) == pytest.approx(a.host_s - b.host_s,
                                                    abs=1e-9)
    # stream intervals: children clipped to the parent, overlaps once
    top.stream, a.stream, b.stream = (0.0, 10.0), (2.0, 6.0), (4.0, 8.0)
    b.parent = top.id
    assert spans.self_time(top, got, stream=True) == pytest.approx(4.0)


def test_backward_spans_follow_their_forward_inside_phsfl_backward(olmoe):
    got = _recorded_round(olmoe)
    kids = _tree(got)
    by_id = {s.id: s for s in got}
    steps = [s for s in got if s.name == "phsfl.local_step"]
    for step in steps:
        fwd, bwd, _ = kids[step.id]
        inside = kids[bwd.id]
        assert [s.name for s in inside] == ["lm_loss.backward"] + [
            "moe.ffn.backward"] * LAYERS
        # the MoE's backward spans run from the last layer to the first
        assert [s.args["layer"] for s in inside[1:]] == list(
            reversed(range(LAYERS)))
        ffns = {s.args["layer"]: s for s in kids[fwd.id]
                if s.name == "moe.ffn"}
        (loss,) = [s for s in kids[fwd.id] if s.name == "lm_loss"]
        assert inside[0].start_ns >= loss.end_ns
        assert inside[0].args == loss.args
        for s in inside[1:]:
            assert by_id[s.parent] is bwd
            assert s.start_ns >= ffns[s.args["layer"]].end_ns
            assert bwd.start_ns <= s.start_ns <= s.end_ns <= bwd.end_ns


def test_records_under_a_cpu_profiler_as_host_events(olmoe):
    assert not spans.on()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert spans.on()
        _round(*olmoe)
    assert not spans.on()
    got = spans.take()
    names = {s.name for s in got}
    assert {"phsfl.round", "moe.ffn.backward", "lm_loss.backward",
            "phsfl.edge"} <= names
    evs = {}
    for e in prof.profiler.kineto_results.events():
        if e.name() in names:
            assert not e.is_user_annotation(), e.name()
            assert e.device_type() == torch.autograd.DeviceType.CPU
            evs.setdefault(e.name(), []).append(e)
    for name in names:
        mine = sorted((s for s in got if s.name == name),
                      key=lambda s: s.start_ns)
        theirs = sorted(evs[name], key=lambda e: e.start_ns())
        assert len(mine) == len(theirs), name
        # the span's time.time_ns() stamps bracket the profiler's event
        for s, e in zip(mine, theirs):
            assert s.start_ns <= e.start_ns() <= e.end_ns() <= s.end_ns, (
                name, s.start_ns, e.start_ns(), e.end_ns(), s.end_ns)


def test_handle_writes_spans_json_and_histograms(olmoe, tmp_path):
    tel = Telemetry(str(tmp_path))
    assert spans.on()
    _bank(*olmoe)
    tel.flush(step=0)
    tel.close()
    assert not spans.on() and spans.finished() == []
    evs = json.load(open(tmp_path / "spans.json"))
    tracks = {e["pid"]: e["args"]["name"] for e in evs if e["ph"] == "M"}
    assert tracks == {0: "host", 1: "stream"}
    xs = [e for e in evs if e["ph"] == "X"]
    assert {e["pid"] for e in xs} == {0}          # no stream on the CPU
    assert sum(e["name"] == "personalize.head_step" for e in xs) == 3 * 2
    assert sum(e["name"] == "personalize.bank" for e in xs) == 1
    snap = [json.loads(ln) for ln in open(tmp_path / "metrics.jsonl")]
    h = snap[0]["metrics"]["span.personalize.head_step.host_s"]
    assert h["kind"] == "histogram" and h["count"] == 6
    assert "span.lm_loss.backward.host_s" in snap[0]["metrics"]
    assert port_check_spans.main([str(tmp_path / "spans.json")]) == 0


def _damaged(evs, how):
    xs = [e for e in evs if e["ph"] == "X" and e["args"]["parent"]
          is not None]
    if how == "orphan":
        xs[0]["args"]["parent"] = 10 ** 9
    elif how == "outside":
        xs[0]["ts"] -= 1e6
    return evs


@pytest.mark.parametrize("how", ["intact", "orphan", "outside"])
def test_port_check_spans_holds_spans_json(olmoe, tmp_path, how):
    spans.attach()
    try:
        _bank(*olmoe)
    finally:
        spans.detach()
    got = spans.take()
    for s in got:                         # a stream track, as on the card
        s.anchor_ns = got[0].start_ns
        s.stream = ((s.start_ns - s.anchor_ns) / 1e6,
                    (s.end_ns - s.anchor_ns) / 1e6)
    evs = _damaged(spans.chrome_events(got), how)
    assert {e["pid"] for e in evs if e["ph"] == "X"} == {0, 1}
    path = tmp_path / "spans.json"
    path.write_text(json.dumps(evs))
    problems = []
    port_check_spans.check(path, problems)
    assert bool(problems) == (how != "intact"), problems
    assert port_check_spans.main([str(path)]) == (how != "intact")


def test_off_a_span_is_the_one_shared_no_op():
    assert spans.span("phsfl.round", round=0) is spans.OFF
    with spans.span("moe.route") as sp:
        assert sp is spans.OFF
    assert spans.finished() == [] and spans.RECORDER.stack == []


def test_a_profiled_run_with_no_handle_keeps_the_newest_spans(monkeypatch):
    monkeypatch.setattr(spans, "KEEP", 8)
    with profile(activities=[ProfilerActivity.CPU]):
        for i in range(21):
            with spans.span("s", i=i):
                pass
    got = spans.finished()
    assert 0 < len(got) <= 8 and got[-1].args["i"] == 20
    assert [s.args["i"] for s in got] == list(range(21 - len(got), 21))
    spans.clear()
    spans.attach()                # a handle takes them: nothing dropped
    try:
        for i in range(21):
            with spans.span("s", i=i):
                pass
    finally:
        spans.detach()
    assert len(spans.take()) == 21


class _Event:
    """A stand-in for a CUDA event recorded at ``t`` ms."""

    def __init__(self, t):
        self.t = t

    def synchronize(self):
        pass

    def elapsed_time(self, other):
        return other.t - self.t


def test_pending_pairs_past_keep_resolve_oldest_first(monkeypatch):
    monkeypatch.setattr(spans, "KEEP", 4)
    got = []
    for i in range(9):
        spans._pend((_Event(0.0), _Event(float(i)), got.append, None))
        assert len(spans.RECORDER.pending) <= 4
    assert got == [float(i) for i in range(len(got))] and got
    spans.resolve()
    assert got == [float(i) for i in range(9)]
