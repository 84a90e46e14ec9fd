from repro_torch.telemetry.sinks import MetricLogger, json_safe

__all__ = ["MetricLogger", "json_safe"]
