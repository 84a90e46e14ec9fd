"""Typed metrics registry: counters, gauges, histograms (stdlib-only).

The port's copy of ``repro.telemetry.metrics``: the same instruments,
the same default buckets, and byte-identical ``flush_jsonl`` lines and
``summary_table`` text.

Three instrument kinds, each a tiny mutable cell registered by name:

- :class:`Counter` — monotone accumulator (``inc``); bits moved, joules
  burned, participants, kernel calls.
- :class:`Gauge` — last-write-wins level (``set``); stale-bank depth,
  eval accuracy, aggregation weight mass.
- :class:`Histogram` — streaming summary of observations (``observe``):
  count/sum/min/max plus fixed-bound bucket counts; round wall times,
  per-kernel wall times.

The :class:`MetricsRegistry` is the single owner: ``counter(name)`` /
``gauge(name)`` / ``histogram(name)`` get-or-create, and re-registering a
name as a DIFFERENT kind raises (a silent kind change would corrupt every
downstream reader).  ``flush_jsonl`` appends one self-describing JSON line
per call (the schema tier-1 CI checks), and ``summary_table`` renders the
run-end plain-text table.

Everything here is host-side Python on plain floats — nothing touches
torch, and an unused registry costs one dict.
"""

from __future__ import annotations

import json
import math


class Counter:
    """Monotone accumulator.  ``inc`` by any non-negative amount."""

    __slots__ = ("name", "help", "value")
    kind = "counter"

    def __init__(self, name: str, help: str = ""):
        self.name, self.help = name, help
        self.value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError(f"counter {self.name!r} cannot decrease "
                             f"(inc by {amount})")
        self.value += float(amount)

    def as_dict(self) -> dict:
        return {"value": self.value}


class Gauge:
    """Last-write-wins level.  ``set`` to any float."""

    __slots__ = ("name", "help", "value")
    kind = "gauge"

    def __init__(self, name: str, help: str = ""):
        self.name, self.help = name, help
        self.value = 0.0

    def set(self, value: float) -> None:
        self.value = float(value)

    def as_dict(self) -> dict:
        return {"value": self.value}


class Histogram:
    """Streaming summary: count/sum/min/max + fixed-bound bucket counts.

    ``buckets`` are the upper bounds of the counting buckets (an implicit
    +inf bucket closes the tail, Prometheus-style cumulative-free counts:
    ``bucket_counts[i]`` is the number of observations in
    ``(bounds[i-1], bounds[i]]``).
    """

    __slots__ = ("name", "help", "bounds", "bucket_counts", "count", "sum",
                 "min", "max")
    kind = "histogram"
    DEFAULT_BOUNDS = (0.001, 0.01, 0.1, 1.0, 10.0, 100.0)

    def __init__(self, name: str, help: str = "", buckets=None):
        self.name, self.help = name, help
        bounds = tuple(float(b) for b in (buckets or self.DEFAULT_BOUNDS))
        if list(bounds) != sorted(bounds):
            raise ValueError(f"histogram {name!r} bucket bounds must be "
                             f"sorted, got {bounds}")
        self.bounds = bounds
        self.bucket_counts = [0] * (len(bounds) + 1)
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf

    def observe(self, value: float) -> None:
        v = float(value)
        self.count += 1
        self.sum += v
        self.min = min(self.min, v)
        self.max = max(self.max, v)
        for i, b in enumerate(self.bounds):
            if v <= b:
                self.bucket_counts[i] += 1
                return
        self.bucket_counts[-1] += 1

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def as_dict(self) -> dict:
        return {"count": self.count, "sum": self.sum,
                "min": self.min if self.count else None,
                "max": self.max if self.count else None,
                "mean": self.mean if self.count else None,
                "bounds": list(self.bounds),
                "bucket_counts": list(self.bucket_counts)}


_KINDS = {c.kind: c for c in (Counter, Gauge, Histogram)}


class MetricsRegistry:
    """Get-or-create instrument store with JSONL flush + summary table."""

    def __init__(self):
        self._instruments: dict[str, object] = {}

    def _get(self, cls, name: str, help: str, **kw):
        inst = self._instruments.get(name)
        if inst is None:
            inst = cls(name, help, **kw)
            self._instruments[name] = inst
            return inst
        if not isinstance(inst, cls):
            raise TypeError(
                f"metric {name!r} already registered as {inst.kind}, "
                f"cannot re-register as {cls.kind}")
        return inst

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  buckets=None) -> Histogram:
        return self._get(Histogram, name, help, buckets=buckets)

    def __contains__(self, name: str) -> bool:
        return name in self._instruments

    def __getitem__(self, name: str):
        return self._instruments[name]

    def names(self) -> list[str]:
        return sorted(self._instruments)

    def snapshot(self) -> dict:
        """All instruments as one JSON-safe {name: {kind, ...state}} dict
        (the JSONL record body; sorted for byte-stable output)."""
        return {name: {"kind": self._instruments[name].kind,
                       **self._instruments[name].as_dict()}
                for name in self.names()}

    def flush_jsonl(self, fh, *, step: int | None = None) -> dict:
        """Append one JSON line: ``{"step": ..., "metrics": snapshot}``.
        Returns the record (tests assert the schema on it)."""
        rec = {"step": step, "metrics": self.snapshot()}
        fh.write(json.dumps(rec, sort_keys=True) + "\n")
        return rec

    def summary_table(self) -> str:
        """Run-end plain-text table, one instrument per row."""
        rows = [("metric", "kind", "value")]
        for name in self.names():
            inst = self._instruments[name]
            if inst.kind == "histogram":
                val = (f"n={inst.count} mean={inst.mean:.6g} "
                       f"min={inst.min:.6g} max={inst.max:.6g}"
                       if inst.count else "n=0")
            else:
                val = f"{inst.value:.6g}"
            rows.append((name, inst.kind, val))
        widths = [max(len(r[i]) for r in rows) for i in range(3)]
        lines = []
        for i, r in enumerate(rows):
            lines.append("  ".join(c.ljust(w) for c, w in zip(r, widths))
                         .rstrip())
            if i == 0:
                lines.append("  ".join("-" * w for w in widths))
        return "\n".join(lines)
