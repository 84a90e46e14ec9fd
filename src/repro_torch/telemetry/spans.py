"""Spans: named intervals inside the program's layers, on the host's
clock and on the CUDA stream.

A span records its name, its parent (the innermost span open when it
opened), its ``index`` among its parent's children of the same name, a
small ``args`` dict (round, client, local step, head step, layer where
they exist), and its host start and end in ``time.time_ns()``: the Unix
clock the torch profiler stamps its events in.  While CUDA is in use it
also records an event pair on the current stream; the pair gives the
span's **stream time**, the device's elapsed time from the span's first
work to its last, waits for launches included.  Pairs are resolved only
when the spans are read (:func:`resolve`, ``Telemetry.flush`` /
``close``), never at the site.  A span's self time is its time less what
its child spans cover (:func:`self_time`).

**When it records.**  While a ``Telemetry`` handle is on (:func:`attach`)
or a torch profiler runs (``torch.autograd.profiler._is_profiler_enabled``),
so a profiled run gets spans with no change to its caller.  While
recording, each span also opens a ``_RecordFunctionFast`` range of its
name: a host range only, which names the host's time in a host-traced
profile and is never drawn on the device's timeline
(``torch.profiler.record_function`` ranges are user annotations, which
the profiler also draws there).  A site opens a span as ``with
span(name, **args):``; off, :func:`span` reads two module globals and
hands back :data:`OFF`, one shared no-op context: no span object, no
profiler call and no autograd node.  On or off, every number a site
computes is the same.

**Bounded.**  A profiled run may have no reader that takes its spans,
so with no handle on the recorder keeps the newest spans only (at most
:data:`KEEP`), and at any time it resolves the oldest event pairs once
:data:`KEEP` are pending, so neither list grows without bound.

**Backward.**  A layer's backward runs inside autograd, where no ``with``
block reaches.  While recording, :func:`mark_inputs` puts an identity
autograd Function on the layer's inputs that take a gradient and
:func:`mark_output` one on its output: the output marker's backward
opens ``<name>.backward`` and the input marker's closes it.  Both pass
the gradient on as it is (no copy, no kernel).  The engine runs the
nodes created between the two markers before the input marker, by
sequence number, so the span covers the layer's backward nodes and the
gradient sums they feed.

Open spans are one stack for the process, not one per thread: a
backward span opens on the autograd engine's device thread while the
thread that called ``backward`` waits inside its own span, which is the
backward span's parent.
"""

from __future__ import annotations

import builtins
import json
import time

import torch
from torch.autograd import profiler as _profiler

_RF = torch._C._profiler._RecordFunctionFast

_handles = 0          # Telemetry handles that are on
KEEP = 16384          # closed spans kept with no handle on; pending pairs


class Span:
    """One span.  ``start_ns`` / ``end_ns``: the host's Unix clock;
    ``stream``: (start, end) in ms after the stream's anchor event, whose
    host time is ``anchor_ns``, or None (no CUDA, or not resolved yet)."""

    __slots__ = ("name", "id", "parent", "index", "args", "start_ns",
                 "end_ns", "stream", "anchor_ns", "_ev0", "_rf", "_kids")

    def __init__(self, name: str, id: int, parent, index: int, args: dict):
        self.name, self.id, self.parent = name, id, parent
        self.index, self.args = index, args
        self.start_ns = self.end_ns = None
        self.stream = self.anchor_ns = self._ev0 = self._rf = None
        self._kids: dict = {}

    @property
    def host_s(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9

    @property
    def stream_ms(self) -> float | None:
        return None if self.stream is None else self.stream[1] - self.stream[0]

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        close(self)
        return False


class _Off:
    """What :func:`span` hands back while nothing records."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


OFF = _Off()


class Recorder:
    """The process's spans: the open stack, the closed spans not yet
    taken, and the event pairs not yet resolved."""

    def __init__(self):
        self.clear()

    def clear(self) -> None:
        self.stack: list = []
        self.done: list = []
        self.pending: list = []        # (ev0, ev1, Span or on_ms, anchor)
        self.roots: dict = {}          # top-level spans by name: count
        self.next_id = 0
        self.anchor = None             # (event, host ns after its sync)

    def anchored(self):
        """The stream's anchor: one event, one synchronise, the host's
        clock read after it (made when the first span on CUDA opens)."""
        if self.anchor is None:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            ev.synchronize()
            self.anchor = (ev, time.time_ns())
        return self.anchor


RECORDER = Recorder()


def on() -> bool:
    """Whether spans record: a ``Telemetry`` handle is on or a torch
    profiler runs."""
    return _handles > 0 or _profiler._is_profiler_enabled


def attach() -> None:
    """A ``Telemetry`` handle turns on; the first one starts recording
    with a fresh stream anchor."""
    global _handles
    if _handles == 0 and not RECORDER.stack:
        RECORDER.anchor = None
    _handles += 1


def detach() -> None:
    global _handles
    _handles = max(_handles - 1, 0)


def span(name: str, **args):
    """A span over a ``with`` block: opened now (:func:`open`), closed
    when the block ends; :data:`OFF` while spans do not record."""
    return open(name, **args) if on() else OFF


def open(name: str, **args) -> Span:
    """Open a span inside the innermost open one (callers check
    :func:`on` first; :func:`close` ends it)."""
    rec = RECORDER
    parent = rec.stack[-1] if rec.stack else None
    kids = parent._kids if parent is not None else rec.roots
    index = kids.get(name, 0)
    kids[name] = index + 1
    sp = Span(name, rec.next_id, None if parent is None else parent.id,
              index, args)
    rec.next_id += 1
    sp.start_ns = time.time_ns()
    sp._rf = _RF(name)
    sp._rf.__enter__()
    if torch.cuda.is_initialized():
        anchor = rec.anchored()
        ev0 = torch.cuda.Event(enable_timing=True)
        ev0.record()
        sp._ev0 = (ev0, anchor)
    rec.stack.append(sp)
    return sp


def close(sp: Span) -> None:
    """Close ``sp``, first closing any span left open inside it (a
    backward span whose input marker took no gradient)."""
    rec = RECORDER
    if sp._rf is None:
        return                          # closed already
    if any(s is sp for s in rec.stack):
        while rec.stack[-1] is not sp:
            close(rec.stack[-1])
        rec.stack.pop()
    if sp._ev0 is not None:
        ev1 = torch.cuda.Event(enable_timing=True)
        ev1.record()
        ev0, anchor = sp._ev0
        _pend((ev0, ev1, sp, anchor))
        sp._ev0 = None
    sp._rf.__exit__(None, None, None)
    sp._rf = None
    sp.end_ns = time.time_ns()
    sp._kids = {}
    rec.done.append(sp)
    if _handles == 0 and len(rec.done) > KEEP:
        del rec.done[:len(rec.done) - KEEP // 2]   # nobody took them


def _pend(pair) -> None:
    """Queue an event pair; past :data:`KEEP` pending, resolve the
    oldest half (their work is long done, so this does not wait)."""
    RECORDER.pending.append(pair)
    if len(RECORDER.pending) > KEEP:
        _resolve(KEEP // 2)


def start_pair():
    """An event recorded on the current stream, or None without CUDA:
    the start of a timed call (the kernel probes)."""
    if not torch.cuda.is_initialized():
        return None
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


def end_pair(ev0, on_ms) -> None:
    """End the call ``ev0`` started; ``on_ms(stream ms)`` runs when the
    pair is resolved."""
    ev1 = torch.cuda.Event(enable_timing=True)
    ev1.record()
    _pend((ev0, ev1, on_ms, None))


def resolve() -> None:
    """Resolve every pending event pair: each closed span's ``stream``
    and each timed call's callback, in the order they were recorded.
    Waits for the last pair's work."""
    _resolve(len(RECORDER.pending))


def _resolve(n: int) -> None:
    """Resolve the ``n`` oldest pending pairs."""
    pending = RECORDER.pending[:n]
    del RECORDER.pending[:n]
    for ev0, ev1, target, anchor in pending:
        ev1.synchronize()
        if anchor is None:
            target(ev0.elapsed_time(ev1))
        else:
            a, target.anchor_ns = anchor
            target.stream = (a.elapsed_time(ev0), a.elapsed_time(ev1))


def finished() -> list:
    """The closed spans not yet taken, in closing order (unresolved ones
    have ``stream`` None until :func:`resolve`)."""
    return list(RECORDER.done)


def take() -> list:
    """Resolve, then hand over the closed spans and forget them."""
    resolve()
    done, RECORDER.done = RECORDER.done, []
    return done


def clear() -> None:
    """Forget every span, open or closed, and the stream anchor."""
    for sp in RECORDER.stack:
        if sp._rf is not None:
            sp._rf.__exit__(None, None, None)
    RECORDER.clear()


def _children(spans) -> dict:
    kids: dict = {}
    for s in spans:
        kids.setdefault(s.parent, []).append(s)
    return kids


def self_time(sp: Span, spans, stream: bool = False, kids=None):
    """``sp``'s time less what its children among ``spans`` cover: host
    seconds, or with ``stream`` stream ms (None when unresolved).
    ``kids``: ``spans`` grouped by parent, when the caller has it."""
    def interval(s):
        return s.stream if stream else (s.start_ns, s.end_ns)

    outer = interval(sp)
    if outer is None:
        return None
    kids = _children(spans) if kids is None else kids
    a0, a1 = outer
    covered, reach = 0.0, a0
    for s, e in sorted(interval(k) for k in kids.get(sp.id, ())
                       if interval(k) is not None):
        s, e = max(s, reach), min(e, a1)
        if e > s:
            covered += e - s
            reach = e
    return (a1 - a0) - covered if stream else ((a1 - a0) - covered) / 1e9


# ---------------------------------------------------------- backward ----
class _InputMark(torch.autograd.Function):
    """At a layer's inputs: the backward closes the layer's backward
    span."""

    @staticmethod
    def forward(ctx, box, *xs):
        ctx.box = box
        return xs

    @staticmethod
    def backward(ctx, *grads):
        if ctx.box:
            close(ctx.box.pop())
        return (None, *grads)


class _OutputMark(torch.autograd.Function):
    """At a layer's output: the backward opens the layer's backward
    span."""

    @staticmethod
    def forward(ctx, box, name, args, x):
        ctx.box, ctx.name, ctx.args = box, name, args
        return x

    @staticmethod
    def backward(ctx, grad):
        ctx.box.append(open(ctx.name, **ctx.args))
        return None, None, None, grad


def mark_inputs(sp: Span, *xs):
    """(mark, xs): ``xs`` (a layer's inputs) through the input marker of
    ``sp``'s backward span, ``<name>.backward`` with ``sp``'s args.  Only
    the tensors that take a gradient go through it; mark is None, and
    ``xs`` come back as they are, when none does."""
    if not torch.is_grad_enabled():
        return None, xs
    need = [i for i, x in enumerate(xs) if x.requires_grad]
    if not need:
        return None, xs
    mark = (f"{sp.name}.backward", sp.args, [])
    got = _InputMark.apply(mark[2], *(xs[i] for i in need))
    out = list(xs)
    for i, x in zip(need, got):
        out[i] = x
    return mark, tuple(out)


def mark_output(mark, out: torch.Tensor) -> torch.Tensor:
    """``out`` (the layer's output) through the output marker of
    ``mark`` (from :func:`mark_inputs`); as it is when mark is None."""
    if mark is None or not out.requires_grad:
        return out
    name, args, box = mark
    return _OutputMark.apply(box, name, dict(args), out)


# ------------------------------------------------------------ export ----
def chrome_events(spans) -> list:
    """``spans`` as Chrome trace events on the profiler's Unix clock in
    us: a host track (pid 0) and, for resolved spans, a stream track
    (pid 1) placed on that clock by the stream's anchor.  Each event's
    args hold the span's args, its ``id``, ``parent``, ``index`` and self
    time."""
    kids = _children(spans)
    evs = [{"ph": "M", "pid": 0, "name": "process_name",
            "args": {"name": "host"}},
           {"ph": "M", "pid": 1, "name": "process_name",
            "args": {"name": "stream"}}]
    for s in spans:
        common = {"id": s.id, "parent": s.parent, "index": s.index,
                  **s.args}
        evs.append({"ph": "X", "pid": 0, "tid": 0, "name": s.name,
                    "ts": s.start_ns / 1e3,
                    "dur": (s.end_ns - s.start_ns) / 1e3,
                    "args": {**common, "self_us": 1e6 * self_time(
                        s, spans, kids=kids)}})
        if s.stream is not None:
            evs.append({"ph": "X", "pid": 1, "tid": 0, "name": s.name,
                        "ts": s.anchor_ns / 1e3 + s.stream[0] * 1e3,
                        "dur": s.stream_ms * 1e3,
                        "args": {**common, "self_us": 1e3 * self_time(
                            s, spans, stream=True, kids=kids)}})
    return evs


def write_chrome(path: str, spans) -> None:
    with builtins.open(path, "w") as fh:
        json.dump(chrome_events(spans), fh)
