"""Per-client event timelines for one edge round (serial and pipelined).

This module is the scheduler's event model: instead of one scalar per
client ("round time = 2*latency + uplink airtime + downlink airtime +
compute"), each client's round is an explicit sequence of SEGMENTS —
compute chunks, uplink transmissions, and the downlink reception — each
with a start, an end, a bit count, and the joules burned while it runs.
Every scheduler quantity (the deadline gate, the energy charge, the
moved-bits ledger, the round clock) is derived from the same timeline, so
they can never disagree.

Two builders share one dataclass:

- **serial** (``pipeline=False``): the paper's Eq.-17 model.  One compute
  segment (kappa0 local epochs), then one uplink segment (the whole round's
  uplink traffic), then the downlink.  The aggregate arithmetic is kept in
  the exact historical expression order, so the serial timeline reproduces
  the pre-timeline scheduler bit-for-bit (the golden regression pins it).
- **pipelined** (``pipeline=True``): minibatch-granular streaming
  (Accelerating SFL, Xu et al.).  The compute splits into ``bits.chunks``
  equal chunks (one per minibatch of the kappa0 local epochs); chunk ``i``'s
  activation payload (``bits.up_stream`` bits) is eligible to transmit as
  soon as chunk ``i``'s compute finishes AND the radio finished payload
  ``i-1``.  With per-chunk compute ``c = compute_s / n`` and per-payload
  airtime ``u = up_stream / rate`` the recurrence closes to

        tx_start[i] = max((i+1) * c, c + i * u)
        tx_end[i]   = tx_start[i] + u

    (induction: the radio is busy ``u`` per payload once it starts, and can
    never start before the payload exists), so the uplink finishes at

        c + u + (n - 1) * max(c, u) + tail_airtime

    — ``max(compute, tx)`` per steady-state slot plus one fill bubble of
    ``min(c, u)``, plus the client-block offload tail (``bits.up_tail``,
    ready only after the last minibatch).  The serial uplink finish is
    ``n*c + n*u + tail``, so pipelining saves exactly ``(n-1) * min(c, u)``
    >= 0: the pipelined completion time is NEVER worse, and degenerates to
    the serial one when ``n == 1``, when compute is free (``c == 0``), or
    when the decomposition is absent.

Deadline semantics (both builders): activity segments are LATENCY-FREE,
exactly like the pre-timeline straggler charge — latency is charged on the
round CLOCK (``times_s``), not against the transmit window.  A deadline at
``T`` freezes every segment at ``T``: ``compute_charged_s`` /
``tx_charged_s`` / ``down_window_s`` are the per-segment overlaps with
``[0, T]``, and the moved-bits ledger prices ``rate * overlap``.

Fault-injected rounds (``plan`` from ``repro_torch.wireless.faults``) route to a
THIRD builder that expands each payload into its HARQ attempt segments
(erased attempts retransmit after a backoff gap) and truncates a crashed
client's cap below the deadline — the per-segment overlap machinery above
then prices retransmissions and crashes with no new accounting rules.  The
fault-free builders are never touched by a ``plan=None`` call, preserving
their bit-identity guarantees.

The port's copy of ``repro.wireless.timeline``: numpy, as in the reference,
with its imports pointed at the port.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.wireless.channel import LinkState, RoundBits


@dataclass
class RoundTimeline:
    """Explicit per-client activity timeline of one edge round.

    All segment clocks are LATENCY-FREE activity time (t=0 is when the
    client starts computing); ``times_s`` is the only field on the round
    clock (it adds the 2*latency propagation term).  Segment arrays are
    ``(U, n)`` with ``n`` segments per client; scalars broadcast.
    """
    pipelined: bool
    # compute segments: chunk i runs over [comp_start[:, i], comp_end[:, i])
    comp_start: np.ndarray     # (U, n)
    comp_end: np.ndarray       # (U, n)
    # uplink segments: payload i transmits over [tx_start[:, i], tx_end[:, i])
    tx_start: np.ndarray       # (U, m)  (m = n + 1 with an offload tail)
    tx_end: np.ndarray         # (U, m)
    tx_bits: np.ndarray        # (U, m) bits of each uplink payload
    # downlink segment (starts when the uplink finishes, latency-free)
    down_start: np.ndarray     # (U,)
    down_end: np.ndarray       # (U,)
    # authoritative aggregates (the scheduler's decision quantities)
    times_s: np.ndarray        # (U,) round-clock completion (2*latency + act)
    compute_s: np.ndarray      # (U,) total compute time (uncapped)
    compute_charged_s: np.ndarray  # (U,) compute seconds within the deadline
    tx_charged_s: np.ndarray   # (U,) uplink seconds within the deadline
    down_window_s: np.ndarray  # (U,) downlink seconds within the deadline
    can_tx: np.ndarray         # (U,) bool: >= 1 uplink bit movable in window
    # ---- fault extension (None on the fault-free builders) ----
    cap_s: np.ndarray = None       # (U,) per-client activity cutoff actually
    #                                charged: min(deadline, crash instant)
    crashed: np.ndarray = None     # (U,) bool: crashed before finishing
    up_ok_all: np.ndarray = None   # (U,) bool: every uplink payload was
    #                                DELIVERED (erasure-survived) within cap
    down_ok: np.ndarray = None     # (U,) bool: downlink delivered within cap
    up_done: np.ndarray = None     # (U,) bool: uplink ACTIVITY (all attempts,
    #                                delivered or not) finished within cap
    down_done: np.ndarray = None   # (U,) bool: downlink activity finished
    air_up_bits: np.ndarray = None    # (U,) exact uplink AIR bits (every
    #                                attempt counts; retransmits included)
    air_down_bits: np.ndarray = None  # (U,) exact downlink air bits
    goodput_up_bits: np.ndarray = None  # (U,) nominal bits of the uplink
    #                                payloads actually DELIVERED within cap
    first_tx_s: np.ndarray = None  # (U,) capped airtime of FIRST attempts
    #                                only (tx_charged_s minus this prices
    #                                the retransmission overhead)
    first_down_s: np.ndarray = None  # (U,) capped first-attempt downlink s
    tx_payload: np.ndarray = None  # (m,) payload index of each uplink
    #                                column (attempt-expanded fault rounds
    #                                have several columns per payload)
    tx_attempt: np.ndarray = None  # (m,) HARQ attempt index per column
    #                                (0 = first transmission, >0 = retx)

    def charge_j(self, tx_power_w: float, compute_power_w: float):
        """Deadline-capped joules: what a scheduled client actually pays."""
        return (tx_power_w * self.tx_charged_s
                + compute_power_w * self.compute_charged_s)

    def segments(self, u: int) -> list[dict]:
        """Client ``u``'s timeline as readable rows (for reports/examples)."""
        rows = []
        for i in range(self.comp_start.shape[1]):
            rows.append({"kind": "compute", "start": float(self.comp_start[u, i]),
                         "end": float(self.comp_end[u, i])})
        for i in range(self.tx_start.shape[1]):
            if self.tx_bits[u, i] > 0 or self.tx_start.shape[1] == 1:
                rows.append({"kind": "uplink", "start": float(self.tx_start[u, i]),
                             "end": float(self.tx_end[u, i]),
                             "bits": float(self.tx_bits[u, i])})
        rows.append({"kind": "downlink", "start": float(self.down_start[u]),
                     "end": float(self.down_end[u])})
        return sorted(rows, key=lambda r: (r["start"], r["end"]))


def _overlap(start, length, deadline):
    """Per-segment overlap of [start, start+length) with [0, deadline)."""
    return np.clip(deadline - start, 0.0, length)


def build_timeline(link: LinkState, bits: RoundBits, comp_s: np.ndarray,
                   deadline_s: float, U: int, *, pipeline: bool = False,
                   plan=None) -> RoundTimeline:
    """Build one round's per-client timeline at the given link rates.

    ``pipeline=False`` keeps the serial aggregates in the exact historical
    expression order (2*latency + t_up + t_down + compute; the capped
    window ``min(airtime, max(deadline - compute, 0))``) so the serial path
    is bit-identical to the pre-timeline scheduler.

    ``plan`` (a :class:`repro_torch.wireless.faults.FaultPlan`) routes to the
    fault builder: every payload expands into its HARQ attempt segments and
    a crashed client's cap truncates below the deadline.  ``plan=None``
    (default, and every fault-free config) never touches this branch.
    """
    if plan is not None:
        return _faulty(link, bits, comp_s, deadline_s, U, plan, pipeline)
    if pipeline:
        return _pipelined(link, bits, comp_s, deadline_s, U)
    return _serial(link, bits, comp_s, deadline_s, U)


def _serial(link, bits, comp_s, deadline_s, U):
    comp_s = np.broadcast_to(np.asarray(comp_s, float), (U,))
    with np.errstate(divide="ignore"):
        t_up_clock = bits.uplink / link.uplink_bps
        t_down = bits.downlink / link.downlink_bps
        t_up = np.asarray(bits.uplink, float) / link.uplink_bps
    t_up = np.where(np.isfinite(t_up), t_up, 0.0)
    t_down_f = np.where(np.isfinite(t_down), t_down, 0.0)
    # the historical round-clock expression, verbatim association order
    times = 2 * link.latency_s + t_up_clock + t_down + comp_s
    c_s = np.minimum(comp_s, deadline_s)
    window = np.maximum(deadline_s - comp_s, 0.0)
    tx_s = np.minimum(t_up, window)
    up_end = comp_s + t_up
    down_start = up_end                   # downlink follows the full uplink
    return RoundTimeline(
        pipelined=False,
        comp_start=np.zeros((U, 1)), comp_end=comp_s.reshape(U, 1),
        tx_start=comp_s.reshape(U, 1), tx_end=up_end.reshape(U, 1),
        tx_bits=np.broadcast_to(np.asarray(bits.uplink, float),
                                (U,)).reshape(U, 1),
        down_start=down_start, down_end=down_start + t_down_f,
        times_s=np.broadcast_to(np.asarray(times, float), (U,)),
        compute_s=comp_s, compute_charged_s=c_s, tx_charged_s=tx_s,
        down_window_s=_overlap(down_start, t_down_f, deadline_s),
        can_tx=window > 0)


def _pipelined(link, bits, comp_s, deadline_s, U):
    comp_s = np.broadcast_to(np.asarray(comp_s, float), (U,))
    n = max(int(bits.chunks), 1)
    stream = bits.up_stream if bits.up_stream is not None else bits.uplink
    tail = bits.up_tail if bits.up_stream is not None else 0.0
    stream = np.broadcast_to(np.asarray(stream, float), (U,))
    tail = np.broadcast_to(np.asarray(tail, float), (U,))
    with np.errstate(divide="ignore"):
        u = stream / link.uplink_bps
        t_tail = tail / link.uplink_bps
        t_down = np.asarray(bits.downlink, float) / link.downlink_bps
    u = np.where(np.isfinite(u), u, 0.0)
    t_tail = np.where(np.isfinite(t_tail), t_tail, 0.0)
    t_down = np.where(np.isfinite(t_down), t_down, 0.0)
    c = comp_s / n                                   # per-minibatch compute
    i = np.arange(n)[None, :]                        # (1, n) chunk index
    comp_start = i * c[:, None]
    comp_end = (i + 1) * c[:, None]
    # closed form of the streaming recurrence (see module docstring)
    tx_start = np.maximum((i + 1) * c[:, None], c[:, None] + i * u[:, None])
    tx_end = tx_start + u[:, None]
    tail_start = tx_end[:, -1]                       # offload after last chunk
    tail_end = tail_start + t_tail
    up_finish = tail_end
    down_start = up_finish
    times = 2 * link.latency_s + up_finish + t_down
    c_s = np.minimum(comp_s, deadline_s)
    tx_s = (_overlap(tx_start, u[:, None], deadline_s).sum(axis=1)
            + _overlap(tail_start, t_tail, deadline_s))
    # a pipelined client can move a bit as soon as its FIRST chunk computes
    can_tx = c < deadline_s
    return RoundTimeline(
        pipelined=True,
        comp_start=comp_start, comp_end=comp_end,
        tx_start=np.concatenate([tx_start, tail_start[:, None]], axis=1),
        tx_end=np.concatenate([tx_end, tail_end[:, None]], axis=1),
        tx_bits=np.concatenate([np.broadcast_to(stream[:, None], (U, n)),
                                tail[:, None]], axis=1),
        down_start=down_start, down_end=down_start + t_down,
        times_s=np.broadcast_to(np.asarray(times, float), (U,)),
        compute_s=comp_s, compute_charged_s=c_s, tx_charged_s=tx_s,
        down_window_s=_overlap(down_start, t_down, deadline_s),
        can_tx=can_tx)


def _faulty(link, bits, comp_s, deadline_s, U, plan, pipeline):
    """Fault-expanded timeline: HARQ attempt segments + crash truncation.

    Each uplink payload (one monolithic payload serially; ``chunks`` stream
    payloads plus the offload tail pipelined) becomes ``plan.up_attempts``
    back-to-back attempt segments — each retransmission waits ``backoff_s``
    after the previous attempt ends — and the downlink broadcast likewise.
    A crashed client's cap is ``min(deadline, crash instant)``; every
    charge/credit is the per-segment overlap with ``[0, cap)``, so
    retransmissions and crashes are priced by the SAME freeze rule as
    deadline stragglers.  Compute runs contiguously over ``[0, comp_s)`` in
    both shapes, so its capped charge stays ``min(comp_s, cap)``.
    """
    comp_s = np.asarray(np.broadcast_to(np.asarray(comp_s, float), (U,)),
                        float)
    back = float(plan.backoff_s)
    up_rate = np.broadcast_to(np.asarray(link.uplink_bps, float), (U,))
    down_bits = np.broadcast_to(np.asarray(bits.downlink, float), (U,))
    with np.errstate(divide="ignore", invalid="ignore"):
        t_down1 = down_bits / link.downlink_bps
    t_down1 = np.where(np.isfinite(t_down1), t_down1, 0.0)

    # payload decomposition: (U, m) ready times and nominal bit counts
    if pipeline:
        n = max(int(bits.chunks), 1)
        stream = bits.up_stream if bits.up_stream is not None else bits.uplink
        tail = bits.up_tail if bits.up_stream is not None else 0.0
        stream = np.broadcast_to(np.asarray(stream, float), (U,))
        tail = np.broadcast_to(np.asarray(tail, float), (U,))
        c = comp_s / n
        i = np.arange(n)
        ready = np.concatenate([(i + 1)[None, :] * c[:, None],
                                comp_s[:, None]], axis=1)        # (U, n+1)
        pay_bits = np.concatenate(
            [np.broadcast_to(stream[:, None], (U, n)), tail[:, None]], axis=1)
        comp_start = i[None, :] * c[:, None]
        comp_end = (i + 1)[None, :] * c[:, None]
        can_tx = c < deadline_s
    else:
        up = np.broadcast_to(np.asarray(bits.uplink, float), (U,))
        ready = comp_s[:, None]
        pay_bits = up[:, None]
        comp_start = np.zeros((U, 1))
        comp_end = comp_s.reshape(U, 1)
        can_tx = comp_s < deadline_s
    m = pay_bits.shape[1]
    assert plan.up_attempts.shape == (U, m), \
        f"fault plan has {plan.up_attempts.shape[1]} uplink payload slots " \
        f"but the timeline needs {m}"
    with np.errstate(divide="ignore", invalid="ignore"):
        dur = pay_bits / up_rate[:, None]
    dur = np.where(np.isfinite(dur), dur, 0.0)

    # expand payloads into attempt segments; the radio is strictly serial
    radio = np.zeros(U)
    tx_starts, tx_ends, tx_bits_cols, first_cols = [], [], [], []
    payload_ids, attempt_ids = [], []
    for i in range(m):
        a = plan.up_attempts[:, i]
        for j in range(int(a.max())):
            live = j < a
            gap = back if j > 0 else 0.0
            start = np.where(live, np.maximum(ready[:, i], radio + gap),
                             radio)
            end = start + np.where(live, dur[:, i], 0.0)
            tx_starts.append(start)
            tx_ends.append(end)
            tx_bits_cols.append(np.where(live, pay_bits[:, i], 0.0))
            first_cols.append(j == 0)
            payload_ids.append(i)
            attempt_ids.append(j)
            radio = end
    up_finish = radio                       # all uplink attempts done
    tx_start = np.stack(tx_starts, axis=1)
    tx_end = np.stack(tx_ends, axis=1)
    tx_bits = np.stack(tx_bits_cols, axis=1)
    first = np.asarray(first_cols, bool)

    # downlink attempts follow the full uplink
    ad = plan.down_attempts
    d_starts, d_ends = [], []
    radio_d = up_finish
    for j in range(int(ad.max())):
        live = j < ad
        gap = back if j > 0 else 0.0
        start = np.where(live, radio_d + gap, radio_d)
        end = start + np.where(live, t_down1, 0.0)
        d_starts.append(start)
        d_ends.append(end)
        radio_d = end
    down_end_act = radio_d
    d_start = np.stack(d_starts, axis=1)
    d_end = np.stack(d_ends, axis=1)

    # crash cap: the activity-clock instant the client dies (inf = never).
    # Finite deadline: a fraction of the deadline window; infinite deadline:
    # a fraction of the client's own activity span (always mid-round).
    span = deadline_s if np.isfinite(deadline_s) else down_end_act
    with np.errstate(invalid="ignore"):
        crash_t = np.where(np.isfinite(plan.crash_frac),
                           plan.crash_frac * span, np.inf)
    cap = np.minimum(deadline_s, crash_t)
    crashed = crash_t < down_end_act

    # per-segment overlaps with [0, cap): the one freeze rule prices
    # compute, every uplink attempt, and every downlink attempt
    ov = _overlap(tx_start, tx_end - tx_start, cap[:, None])
    tx_charged = ov.sum(axis=1)
    first_tx_s = (ov * first[None, :]).sum(axis=1)
    ovd = _overlap(d_start, d_end - d_start, cap[:, None])
    down_window = ovd.sum(axis=1)
    first_down_s = ovd[:, 0]
    compute_charged = np.minimum(comp_s, cap)

    # a payload is delivered iff it erasure-survived AND its last attempt
    # ends within the cap
    pay_end = np.empty((U, m))
    col = 0
    for i in range(m):
        a = plan.up_attempts[:, i]
        width = int(a.max())
        ends = tx_end[:, col:col + width]
        pay_end[:, i] = ends[np.arange(U), a - 1]
        col += width
    delivered = plan.up_ok & (pay_end <= cap[:, None])
    goodput_up = (pay_bits * delivered).sum(axis=1)
    up_ok_all = delivered.all(axis=1)
    up_done = up_finish <= cap
    down_done = down_end_act <= cap
    down_ok = plan.down_ok & down_done

    times = 2 * link.latency_s + down_end_act
    air_up = (pay_bits * plan.up_attempts).sum(axis=1)
    air_down = down_bits * ad
    return RoundTimeline(
        pipelined=bool(pipeline),
        comp_start=comp_start, comp_end=comp_end,
        tx_start=tx_start, tx_end=tx_end, tx_bits=tx_bits,
        down_start=d_start[:, 0], down_end=down_end_act,
        times_s=np.broadcast_to(np.asarray(times, float), (U,)),
        compute_s=comp_s, compute_charged_s=compute_charged,
        tx_charged_s=tx_charged, down_window_s=down_window,
        can_tx=can_tx,
        cap_s=cap, crashed=crashed, up_ok_all=up_ok_all, down_ok=down_ok,
        up_done=up_done, down_done=down_done,
        air_up_bits=air_up, air_down_bits=air_down,
        goodput_up_bits=goodput_up,
        first_tx_s=first_tx_s, first_down_s=first_down_s,
        tx_payload=np.asarray(payload_ids, int),
        tx_attempt=np.asarray(attempt_ids, int))
