"""Kernel call instrumentation: count, wall time, bytes, FLOP/s.

The port's copy of ``repro.telemetry.kernels``.  The four Hopper wrappers
(``hopper/<name>/ops.py``: ``quantize_rows``, ``flash_attention``,
``mlstm_chunk``, ``rglru_scan``) call :func:`kernel_probe` at entry,
outside their autograd Functions, so a call's forward is probed once.
With no sink installed (the default) the probe is ``None`` and the wrapper
pays one module-global read — zero overhead, zero behavior change.  With a
sink (a :class:`repro_torch.telemetry.metrics.MetricsRegistry`, installed
by ``Telemetry(kernels=True)`` or :func:`set_kernel_sink`), each call
records under ``kernel.<name>.*``:

- ``calls`` / ``traced_calls`` — concrete executions vs traced visits.
  The port has no jit trace: a call counts as traced (counted, not timed)
  when ``torch.compiler.is_compiling()`` is true or an operand lies on the
  ``meta`` device, where there is no data and no clock.  No path of the
  port does either, so on the card ``calls`` equals the kernel's
  ``launches``.  The reference's FedSim and LM round are jitted, so there
  its probes record only ``traced_calls`` (one per trace) where the port
  records every concrete call.
- ``flops`` / ``bytes`` — nominal work per concrete call, from the
  wrapper's own analytic estimate (the reference's formulas), and the
  operands' and the output's ``nbytes``, accumulated as counters.
- ``wall_s`` — a histogram of per-call time.  On a CUDA output it is the
  wrapper's stream time: an event pair (``telemetry.spans``) recorded at
  wrapper entry and at its return, the device's time from the first to
  the last of the call's work, waits for launches included.  The probe
  never synchronises: the pair is resolved, and ``wall_s`` observed, when
  the pending pairs are (``Telemetry.flush`` / ``close``, or
  ``telemetry.spans.resolve``).  On the CPU it is the host's
  ``perf_counter`` from wrapper entry to its return.
- ``gflops_per_s`` — a gauge of the LAST call's achieved rate
  (``flops / wall``), set when its ``wall_s`` is.
"""

from __future__ import annotations

import time

import torch

from repro_torch.telemetry import spans

_SINK = None      # MetricsRegistry | None; None = instrumentation off


def set_kernel_sink(registry) -> None:
    """Install (or clear, with None) the global kernel metrics sink."""
    global _SINK
    _SINK = registry


def get_kernel_sink():
    return _SINK


def _is_traced(tensors) -> bool:
    return (torch.compiler.is_compiling()
            or any(t.device.type == "meta" for t in tensors))


def _observe(reg, base: str, flops: float, wall: float) -> None:
    reg.histogram(f"{base}.wall_s").observe(wall)
    if wall > 0.0 and flops > 0.0:
        reg.gauge(f"{base}.gflops_per_s").set(flops / wall / 1e9)


class _Probe:
    __slots__ = ("name", "t0", "ev0")

    def __init__(self, name: str):
        self.name = name
        self.t0 = time.perf_counter()
        self.ev0 = spans.start_pair()

    def finish(self, out, *, flops: float = 0.0, arrays=()) -> None:
        """Record the call.  ``arrays`` are the operands whose device
        decides traced-vs-executed and whose ``nbytes``, with the
        output's, is the bytes-moved estimate."""
        reg = _SINK
        if reg is None:
            return
        leaves = [a for a in (*arrays, out) if a is not None]
        base = f"kernel.{self.name}"
        if _is_traced(leaves):
            reg.counter(f"{base}.traced_calls").inc()
            return
        wall = time.perf_counter() - self.t0
        nbytes = float(sum(a.nbytes for a in leaves))
        reg.counter(f"{base}.calls").inc()
        reg.counter(f"{base}.flops").inc(max(float(flops), 0.0))
        reg.counter(f"{base}.bytes").inc(nbytes)
        if out.device.type == "cuda" and self.ev0 is not None:
            spans.end_pair(self.ev0, lambda ms: _observe(reg, base, flops,
                                                         ms / 1e3))
        else:
            _observe(reg, base, flops, wall)


def kernel_probe(name: str):
    """Start a probe for one wrapper call; None when instrumentation is
    off (callers guard their single ``finish`` on that)."""
    if _SINK is None:
        return None
    return _Probe(name)
