"""Back-compat shim: MetricLogger lives in ``repro_torch.telemetry.sinks``
(as ``repro.utils.logging`` re-exports ``repro.telemetry.sinks``).

The logger preserves JSON-native value types and can mirror numeric
values into a :class:`repro_torch.telemetry.Telemetry` metrics registry.
Import from ``repro_torch.telemetry`` in new code.
"""

from __future__ import annotations

from repro_torch.telemetry.sinks import MetricLogger, json_safe

__all__ = ["MetricLogger", "json_safe"]
