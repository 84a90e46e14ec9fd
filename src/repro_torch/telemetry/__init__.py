"""Observability for the PHSFL stack: traces, metrics, manifests.

The port's copy of ``repro.telemetry``: the same handle, files, metric
names and trace layout, with the torch environment in the manifest.

The paper's claims are about time, bits, and energy; this package makes
every one of them inspectable without perturbing a single number:

- **Trace export** (``telemetry.trace``): each wireless round's
  :class:`~repro_torch.wireless.timeline.RoundTimeline` — compute chunks,
  uplink payloads with their HARQ retransmission attempts, downlink,
  crashes — becomes Chrome/Perfetto trace events, one track per client
  and per edge server, streamed to disk by :class:`TraceWriter`.  Open
  the file at https://ui.perfetto.dev or chrome://tracing.
- **Metrics** (``telemetry.metrics``): a stdlib-only typed registry of
  counters/gauges/histograms.  The scheduler registers participation,
  withdrawals/backfills, goodput-vs-retransmit bits, stale-bank
  depth/age, and per-phase energy; FedSim registers round wall time, eval
  accuracy, and live-vs-stale aggregation mass; the Hopper kernel
  wrappers (via ``telemetry.kernels``) register call counts, wall time,
  bytes, and achieved FLOP/s.  Flushed as JSONL plus a run-end summary
  table.
- **Manifest** (``telemetry.manifest``): config hash, seeds, torch/CUDA
  and device info, git SHA — who made this artifact.
- **Spans** (``telemetry.spans``): named intervals inside the round, the
  head bank, the MoE FFN and the loss (forward and backward), on the
  host's Unix clock and, on the card, the CUDA stream.  They record while
  a handle is on or a torch profiler runs, and each is also a host-only
  profiler range of its name.  A handle writes them to ``spans.json``
  (Chrome trace: a host track and a stream track) and as
  ``span.<name>.host_s`` / ``span.<name>.stream_s`` histograms.

:class:`Telemetry` bundles them behind one handle.  The OFF state is
the default everywhere (``telemetry=None`` parameters, enforced by the
``telemetry-off-default`` reprolint rule) and is bit-inert: no file I/O,
no RNG, no arithmetic.  ON is bit-inert too: the hooks only read what a
round computed, so every number of the run is unchanged.
"""

from __future__ import annotations

import os

from repro_torch.telemetry import spans
from repro_torch.telemetry.kernels import (get_kernel_sink, kernel_probe,
                                           set_kernel_sink)
from repro_torch.telemetry.manifest import (collect_manifest, config_hash,
                                            write_manifest)
from repro_torch.telemetry.metrics import (Counter, Gauge, Histogram,
                                           MetricsRegistry)
from repro_torch.telemetry.sinks import MetricLogger, json_safe
from repro_torch.telemetry.trace import (TraceWriter, round_span_s,
                                         timeline_to_trace_events)

__all__ = [
    "Telemetry",
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "TraceWriter", "timeline_to_trace_events", "round_span_s",
    "collect_manifest", "config_hash", "write_manifest",
    "MetricLogger", "json_safe",
    "kernel_probe", "set_kernel_sink", "get_kernel_sink",
    "spans",
]


class Telemetry:
    """One handle over the run's trace writer, metrics registry, manifest.

    ``Telemetry(out_dir)`` is the ON state: ``<out_dir>/trace.json``
    (streamed Chrome trace), ``<out_dir>/metrics.jsonl`` (one registry
    snapshot every ``metrics_every`` flushes), ``<out_dir>/manifest.json``
    (via :meth:`write_manifest`), ``<out_dir>/summary.txt`` and
    ``<out_dir>/spans.json`` (at :meth:`close`).  While it is on, spans
    record (``telemetry.spans``); each flush resolves the pending event
    pairs and folds the closed spans into ``span.<name>.host_s`` and
    ``span.<name>.stream_s`` histograms.  ``kernels=True`` additionally
    installs the metrics registry as the global kernel-wrapper sink for
    the lifetime of the handle.

    ``Telemetry.disabled()`` is the OFF state every entry point defaults
    to: ``enabled`` is False and :meth:`record_round` / :meth:`flush` /
    :meth:`close` return immediately — instrumented code stays bit-inert.
    """

    def __init__(self, out_dir: str | None = None, *, trace: bool = True,
                 metrics_every: int = 1, kernels: bool = False,
                 _enabled: bool = True):
        self.enabled = bool(_enabled)
        self.out_dir = out_dir
        self.metrics = MetricsRegistry()
        self.metrics_every = max(int(metrics_every), 1)
        self.trace = None
        self._metrics_fh = None
        self._flushes = 0
        self._owns_kernel_sink = False
        self._closed = False
        self._spans: list = []        # closed spans, for spans.json
        if not self.enabled:
            return
        spans.attach()
        if out_dir is not None:
            os.makedirs(out_dir, exist_ok=True)
            if trace:
                self.trace = TraceWriter(os.path.join(out_dir,
                                                      "trace.json"))
            self._metrics_fh = open(os.path.join(out_dir, "metrics.jsonl"),
                                    "w")
        if kernels:
            set_kernel_sink(self.metrics)
            self._owns_kernel_sink = True

    _DISABLED = None

    @classmethod
    def disabled(cls) -> "Telemetry":
        """The shared OFF instance (the default of every entry point)."""
        if cls._DISABLED is None:
            cls._DISABLED = cls(_enabled=False)
        return cls._DISABLED

    # ------------------------------------------------------------ rounds --
    def record_round(self, report, timeline, *, es_assign=None,
                     deadline_s: float = float("inf"),
                     withdrawn: int = 0, backfilled: int = 0,
                     tx_j: float = 0.0, bank_depth: int = 0,
                     bank_age_max: int = 0) -> None:
        """One scheduler round: trace events + the scheduler's instruments
        (called by ``ParticipationScheduler.step`` when telemetry is on)."""
        if not self.enabled:
            return
        m = self.metrics
        rep = report
        m.counter("sched.rounds").inc()
        m.counter("sched.participants").inc(rep.num_participants)
        if rep.scheduled is not None:
            m.counter("sched.scheduled").inc(int(rep.scheduled.sum()))
        m.counter("sched.withdrawn").inc(int(withdrawn))
        m.counter("sched.backfilled").inc(int(backfilled))
        m.counter("sched.bits_moved").inc(float(rep.bits_tx))
        m.counter("sched.goodput_bits").inc(
            max(float(rep.bits_tx) - float(rep.retx_bits), 0.0))
        m.counter("sched.retx_bits").inc(float(rep.retx_bits))
        m.counter("energy.retx_j").inc(float(rep.retx_j))
        m.counter("energy.tx_j").inc(float(tx_j))
        if rep.compute_j is not None:
            m.counter("energy.compute_j").inc(float(rep.compute_j.sum()))
        m.gauge("sched.participation").set(
            rep.num_participants / max(len(rep.mask), 1))
        m.histogram("sched.round_time_s").observe(float(rep.round_time_s))
        if rep.stale_banked is not None:
            m.counter("stale.banked").inc(int(rep.stale_banked.sum()))
            m.counter("stale.delivered").inc(
                int((rep.stale_delivered > 0).sum()))
            m.counter("stale.dropped").inc(int(rep.stale_dropped.sum()))
            m.gauge("stale.bank_depth").set(int(bank_depth))
            m.gauge("stale.bank_age_max").set(int(bank_age_max))
        if rep.crashed is not None:
            m.counter("faults.crashed").inc(int(rep.crashed.sum()))
            m.counter("faults.failed").inc(int(rep.failed.sum()))
        if rep.es_down is not None:
            m.counter("faults.es_down_rounds").inc(int(rep.es_down.sum()))
        if self.trace is not None:
            self.trace.add_round(report, timeline, es_assign=es_assign,
                                 deadline_s=deadline_s)
        self.flush(step=int(rep.round_idx))

    # ------------------------------------------------------------- sinks --
    def flush(self, step: int | None = None, force: bool = False) -> None:
        """Append one metrics.jsonl snapshot every ``metrics_every`` calls
        (every call with ``force``)."""
        if not self.enabled:
            return
        self._take_spans()
        if self._metrics_fh is None:
            return
        self._flushes += 1
        if force or (self._flushes - 1) % self.metrics_every == 0:
            self.metrics.flush_jsonl(self._metrics_fh, step=step)
            self._metrics_fh.flush()

    def _take_spans(self) -> None:
        """Resolve the pending event pairs (the spans' and the kernel
        probes') and fold the closed spans into the registry."""
        if self._closed:
            return
        got = spans.take()
        for s in got:
            self.metrics.histogram(f"span.{s.name}.host_s").observe(s.host_s)
            if s.stream is not None:
                self.metrics.histogram(f"span.{s.name}.stream_s").observe(
                    s.stream_ms / 1e3)
        if self.out_dir is not None:
            self._spans += got

    def write_manifest(self, *, config=None, seeds=None,
                       extra=None) -> dict | None:
        """Collect and (when an out_dir exists) write manifest.json."""
        if not self.enabled:
            return None
        man = collect_manifest(config=config, seeds=seeds, extra=extra)
        if self.out_dir is not None:
            write_manifest(os.path.join(self.out_dir, "manifest.json"), man)
        return man

    def summary(self) -> str:
        return self.metrics.summary_table()

    def close(self) -> str | None:
        """Final flush, summary.txt, trace finalization.  Idempotent;
        returns the summary table (None when disabled)."""
        if not self.enabled:
            return None
        if self._closed:
            return self.summary()
        self._take_spans()
        self._closed = True
        spans.detach()
        if self._owns_kernel_sink and get_kernel_sink() is self.metrics:
            set_kernel_sink(None)
        table = self.summary()
        if self._metrics_fh is not None:
            self.metrics.flush_jsonl(self._metrics_fh, step=None)
            self._metrics_fh.close()
            self._metrics_fh = None
        if self.out_dir is not None:
            with open(os.path.join(self.out_dir, "summary.txt"), "w") as fh:
                fh.write(table + "\n")
            spans.write_chrome(os.path.join(self.out_dir, "spans.json"),
                               self._spans)
            self._spans = []
        if self.trace is not None:
            self.trace.close()
        return table
