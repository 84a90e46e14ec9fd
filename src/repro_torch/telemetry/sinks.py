"""Line-oriented metric sinks (the home of the old ``utils.logging``).

The port's copy of ``repro.telemetry.sinks``.

:class:`MetricLogger` is the repo's one-line-per-step stdout logger,
folded into the telemetry subsystem: it still prints ``[name] {json}``
lines, but values now keep their JSON-native types (ints stay ints, bools
stay bools, lists stay lists — the old implementation coerced everything
non-float through ``str``, silently stringifying structured values in the
JSONL output), and an optional ``telemetry=`` mirror forwards numeric
values into the run's
:class:`~repro_torch.telemetry.metrics.MetricsRegistry`
as ``log.<name>.<key>`` gauges, so ad-hoc launcher logs land in the same
``metrics.jsonl`` as the structured instruments.

``repro_torch.utils.logging`` is a thin import shim for old call sites.
"""

from __future__ import annotations

import json
import sys
import time


def json_safe(v):
    """Coerce ``v`` to a JSON-native value, preserving its type.

    bool/int/float/str/None pass through; numpy scalars unwrap via
    ``item()``; arrays and sequences become lists (element-wise coerced);
    dicts coerce their values; anything else falls back to ``str``.
    """
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    if hasattr(v, "item") and not hasattr(v, "__len__"):
        try:
            return json_safe(v.item())            # numpy / 0-d array scalar
        except (TypeError, ValueError):
            pass
    if hasattr(v, "tolist"):
        return json_safe(v.tolist())              # ndarray -> nested lists
    if isinstance(v, dict):
        return {str(k): json_safe(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [json_safe(x) for x in v]
    return str(v)


class MetricLogger:
    """Tiny structured logger (stdout, no deps)."""

    def __init__(self, name: str = "repro", stream=None, telemetry=None):
        self.name = name
        self.stream = stream or sys.stdout
        self.telemetry = telemetry
        self._t0 = time.time()

    def log(self, step: int | None = None, **metrics):
        rec = {"t": round(time.time() - self._t0, 3)}
        if step is not None:
            rec["step"] = step
        for k, v in metrics.items():
            rec[k] = json_safe(v)
        print(f"[{self.name}] " + json.dumps(rec), file=self.stream,
              flush=True)
        tel = self.telemetry
        if tel is not None and getattr(tel, "enabled", False):
            for k, v in rec.items():
                if k != "t" and isinstance(v, (bool, int, float)):
                    tel.metrics.gauge(f"log.{self.name}.{k}").set(float(v))
        return rec
