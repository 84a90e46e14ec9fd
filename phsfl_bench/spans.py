"""The port's spans (``repro_torch.telemetry.spans``) as the per-layer
metrics read them: the spans recorded in the traced units, and the
device's busy time inside them.

The recorder turns on while a torch profiler runs, and the untraced
window and set-up run without one, so what it holds when the metrics are
read is the traced units' spans.  A span's stream interval (its CUDA
event pair) is placed on the profiler's Unix clock by the stream's anchor
(``Span.anchor_ns``); the device's busy time inside it is the union of
the traced units' device intervals (``ctx["trace"]["device"]``, on that
clock) clipped to it.  So a layer's reading is the device's work in it,
not the stream's elapsed time, which also holds the device's waits for
the host's launches.  A program without the recorder, or a run without
CUDA events (the CPU), gives no reading.
"""

from __future__ import annotations

import bisect


def traced(ctx: dict, unit: str):
    """(spans, number of ``unit`` spans) of the traced units, or None.
    ``unit`` is the span of one unit of the cell (``phsfl.round``,
    ``personalize.bank``); there must be one a traced unit."""
    if "traced_units" not in ctx:
        return None
    try:
        from repro_torch.telemetry import spans
    except ImportError:                 # a program without spans
        return None
    spans.resolve()
    got = spans.finished()
    n = sum(1 for s in got if s.name == unit)
    if not n or any(s.stream is None for s in got):
        return None
    if n != ctx["traced_units"]:
        raise ValueError(f"{n} {unit} spans in {ctx['traced_units']} "
                         f"traced units")
    return got, n


def count(spans_, name: str) -> int:
    return sum(1 for s in spans_ if s.name == name)


def outermost(spans_, names):
    """The spans named in ``names`` that lie inside none of ``names``: a
    layer's forward recomputed inside its backward is covered by the
    backward's span."""
    names = set(names)
    by_id = {s.id: s for s in spans_}
    for s in spans_:
        if s.name not in names:
            continue
        up = by_id.get(s.parent)
        while up is not None and up.name not in names:
            up = by_id.get(up.parent)
        if up is None:
            yield s


def union(device) -> tuple:
    """The union of ``device``'s (start, end, name) intervals: (starts,
    ends) of disjoint intervals sorted by start, in us."""
    starts, ends = [], []
    for s, t, _ in sorted(device):
        if ends and s <= ends[-1]:
            ends[-1] = max(ends[-1], t)
        else:
            starts.append(s)
            ends.append(t)
    return starts, ends


def busy_us(merged, a: float, b: float) -> float:
    """The busy us in [a, b] of ``merged`` (a :func:`union`): its
    intervals clipped to [a, b]."""
    starts, ends = merged
    total = 0.0
    j = max(bisect.bisect_right(starts, a) - 1, 0)
    while j < len(starts) and starts[j] < b:
        total += max(0.0, min(ends[j], b) - max(starts[j], a))
        j += 1
    return total


def device_ms(ctx: dict, spans_, names) -> float:
    """The device's busy ms inside the stream intervals of the outermost
    spans named in ``names``.  The union is kept in ``ctx["trace"]`` for
    the cell's other readers."""
    tr = ctx["trace"]
    if "union" not in tr:
        tr["union"] = union(tr["device"])
    total = 0.0
    for s in outermost(spans_, names):
        at = s.anchor_ns / 1e3
        total += busy_us(tr["union"], at + s.stream[0] * 1e3,
                         at + s.stream[1] * 1e3)
    return total / 1e3
