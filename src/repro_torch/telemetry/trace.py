"""Chrome/Perfetto trace export for wireless round timelines.

The port's copy of ``repro.telemetry.trace``: the same tracks, event
names and arguments, and ``ts``/``dur`` equal to the reference's as exact
floats (``tests/test_torch_telemetry_trace.py``).

``timeline_to_trace_events`` is a pure function from one round's
:class:`repro_torch.wireless.timeline.RoundTimeline` to Trace Event Format
records (the JSON chrome://tracing and https://ui.perfetto.dev both open):
every compute chunk, uplink payload (HARQ attempts individually, labelled
``uplink[p<payload>.a<attempt>]`` on fault rounds), and the downlink
becomes a complete ("ph": "X") event on its client's track, a crashed
client gets an instant crash marker at its cap, and timestamps are the
timeline's latency-free activity seconds times 1e6 (trace ``ts``/``dur``
are microseconds) offset by the round's start on the run clock.  The
conversion never rounds: ``ts == (t0 + start_s) * 1e6`` and
``dur == (end_s - start_s) * 1e6`` hold with EXACT float equality against
the scheduler's RoundTimeline (asserted in the telemetry tests —
compare in microsecond space; dividing back by 1e6 reintroduces binary
rounding).

:class:`TraceWriter` streams rounds to disk as they happen: it lays rounds
back-to-back on one run clock (each round advances the clock by
``max(round_time_s, last emitted segment end)``), adds one track per client
and per edge server, round-start instant markers, per-ES round/outage
spans, stale-delivery markers, and a deadline marker per finite-deadline
round.  The file is the Trace Event "JSON Array Format" written
incrementally — valid the moment the first event lands (the closing ``]``
is optional in both viewers), so a crashed run still leaves an openable
trace.

Track layout:

- pid 0 ``round markers``  — instant events ``round <r>`` / ``deadline``;
- pid 1 ``clients``        — tid u: client u's compute/uplink/downlink;
- pid 2 ``edge servers``   — tid b: one ``round <r>`` span per round
  (args: that ES's participant count), ``outage`` spans on down rounds.
"""

from __future__ import annotations

import json

import numpy as np

PID_MARKERS = 0
PID_CLIENTS = 1
PID_ES = 2


def _finite(*vals) -> bool:
    return all(np.isfinite(v) for v in vals)


def _us(t_s: float) -> float:
    return float(t_s) * 1e6


def timeline_to_trace_events(tl, round_idx: int, *, t0_s: float = 0.0,
                             clients=None, pid: int = PID_CLIENTS) -> list:
    """One round's per-client segments as Trace Event dicts.

    ``clients`` is an optional (U,) bool mask of tracks to emit (default:
    every client); pass ``RoundReport.scheduled`` to hide the clients that
    never transmitted.  Events are emitted in (client, kind, segment)
    order, so the output is deterministic for a given timeline.  Segments
    with non-finite endpoints (ideal-channel infinities) are skipped —
    they have no screen representation.
    """
    U = tl.comp_start.shape[0]
    sel = (np.ones(U, bool) if clients is None
           else np.asarray(clients, bool))
    n_comp = tl.comp_start.shape[1]
    n_tx = tl.tx_start.shape[1]
    events = []
    for u in range(U):
        if not sel[u]:
            continue
        common = {"pid": pid, "tid": int(u), "cat": "wireless"}
        for i in range(n_comp):
            s, e = float(tl.comp_start[u, i]), float(tl.comp_end[u, i])
            if not _finite(s, e):
                continue
            name = "compute" if n_comp == 1 else f"compute[{i}]"
            events.append({"name": name, "ph": "X", "ts": _us(t0_s + s),
                           "dur": _us(e - s),
                           "args": {"round": int(round_idx)}, **common})
        for i in range(n_tx):
            s, e = float(tl.tx_start[u, i]), float(tl.tx_end[u, i])
            bits = float(tl.tx_bits[u, i])
            # fault builders emit zero-width placeholder columns for
            # attempts a client never made — nothing to draw
            if (bits <= 0.0 and n_tx > 1) or not _finite(s, e):
                continue
            if tl.tx_payload is not None:
                p, a = int(tl.tx_payload[i]), int(tl.tx_attempt[i])
                name = (f"uplink[p{p}.a{a}]" if a > 0
                        else (f"uplink[p{p}]" if tl.tx_payload.max() > 0
                              else "uplink"))
                args = {"round": int(round_idx), "bits": bits,
                        "payload": p, "attempt": a, "retx": a > 0}
            else:
                name = "uplink" if n_tx == 1 else f"uplink[{i}]"
                args = {"round": int(round_idx), "bits": bits}
            events.append({"name": name, "ph": "X", "ts": _us(t0_s + s),
                           "dur": _us(e - s), "args": args, **common})
        s, e = float(tl.down_start[u]), float(tl.down_end[u])
        if _finite(s, e):
            events.append({"name": "downlink", "ph": "X",
                           "ts": _us(t0_s + s), "dur": _us(e - s),
                           "args": {"round": int(round_idx)}, **common})
        if tl.crashed is not None and bool(tl.crashed[u]):
            events.append({"name": "crash", "ph": "i", "s": "t",
                           "ts": _us(t0_s + float(tl.cap_s[u])),
                           "args": {"round": int(round_idx)}, **common})
    return events


def round_span_s(report, tl=None) -> float:
    """How far this round advances the run clock: the simulated round wall
    clock, stretched to cover any emitted segment that outlives it (a
    straggler's uplink keeps transmitting past the deadline on the
    timeline's activity clock), so back-to-back rounds never overlap."""
    span = float(report.round_time_s)
    if tl is not None and report.scheduled is not None:
        sel = np.asarray(report.scheduled, bool)
        if sel.any():
            ends = np.concatenate([tl.tx_end[sel].ravel(),
                                   tl.down_end[sel].ravel(),
                                   tl.comp_end[sel].ravel()])
            ends = ends[np.isfinite(ends)]
            if ends.size:
                span = max(span, float(ends.max()))
    return span if np.isfinite(span) else 0.0


class TraceWriter:
    """Streams trace events to one JSON-array file, round by round."""

    def __init__(self, path):
        self.path = str(path)
        self._fh = open(self.path, "w")
        self._fh.write("[\n")
        self._first = True
        self._named: set = set()
        self.clock_s = 0.0
        self.rounds = 0
        self._meta(PID_MARKERS, None, "round markers")
        self._closed = False

    # -------------------------------------------------------- low level --
    def add_events(self, events) -> None:
        for ev in events:
            self._fh.write(("" if self._first else ",\n") +
                           json.dumps(ev, sort_keys=True))
            self._first = False

    def _meta(self, pid: int, tid: int | None, name: str) -> None:
        """process_name / thread_name metadata, emitted once per track."""
        key = (pid, tid)
        if key in self._named:
            return
        self._named.add(key)
        if tid is None:
            self.add_events([{"name": "process_name", "ph": "M", "pid": pid,
                              "args": {"name": name}}])
        else:
            self._meta(pid, None, {PID_CLIENTS: "clients",
                                   PID_ES: "edge servers"}.get(pid, name))
            self.add_events([{"name": "thread_name", "ph": "M", "pid": pid,
                              "tid": tid, "args": {"name": name}}])

    # ------------------------------------------------------- round level --
    def add_round(self, report, tl, *, es_assign=None,
                  deadline_s: float = float("inf")) -> float:
        """Append one round (report + its timeline) at the current clock;
        advances and returns the new clock."""
        t0 = self.clock_s
        r = int(report.round_idx)
        self.add_events([{"name": f"round {r}", "ph": "i", "s": "g",
                          "ts": _us(t0), "pid": PID_MARKERS, "tid": 0,
                          "cat": "round",
                          "args": {"participants": report.num_participants,
                                   "round_time_s": float(
                                       report.round_time_s)}}])
        if np.isfinite(deadline_s):
            self.add_events([{"name": "deadline", "ph": "i", "s": "g",
                              "ts": _us(t0 + float(deadline_s)),
                              "pid": PID_MARKERS, "tid": 0, "cat": "round",
                              "args": {"round": r}}])
        sel = report.scheduled
        U = len(report.mask)
        for u in range(U):
            if sel is None or sel[u]:
                self._meta(PID_CLIENTS, u, f"client {u}")
        self.add_events(timeline_to_trace_events(
            tl, r, t0_s=t0, clients=sel))
        # stale-bank deliveries: not timeline segments (background pushes),
        # marked as instants on the delivering client's track
        if report.stale_delivered is not None:
            for u in np.flatnonzero(report.stale_delivered > 0):
                self._meta(PID_CLIENTS, int(u), f"client {int(u)}")
                self.add_events([{
                    "name": f"stale delivery (s={int(report.stale_delivered[u])})",
                    "ph": "i", "s": "t", "ts": _us(t0),
                    "pid": PID_CLIENTS, "tid": int(u), "cat": "wireless",
                    "args": {"round": r}}])
        span = round_span_s(report, tl)
        if es_assign is not None:
            ea = np.asarray(es_assign, int)
            live = np.asarray(report.mask) > 0
            for b in range(int(ea.max()) + 1):
                self._meta(PID_ES, b, f"ES {b}")
                down = (report.es_down is not None
                        and b < len(report.es_down)
                        and bool(report.es_down[b]))
                self.add_events([{
                    "name": "outage" if down else f"round {r}",
                    "ph": "X", "ts": _us(t0), "dur": _us(span),
                    "pid": PID_ES, "tid": b, "cat": "es",
                    "args": {"round": r,
                             "participants": int(live[ea == b].sum())}}])
        self.clock_s = t0 + span
        self.rounds += 1
        return self.clock_s

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._fh.write("\n]\n")
        self._fh.close()
