"""Seeded, deterministic fault injection for the wireless simulator.

Three hazards, all drawn from ONE dedicated RNG stream (``cfg.seed +
FAULT_SEED_OFFSET``, disjoint from the channel's ``seed``, the scheduler's
``seed+1``, the device model's ``seed+2`` and personalization's ``seed+3``
streams, so switching faults on never perturbs fading, thinning, or device
heterogeneity draws):

- **Payload erasures + HARQ** (``erasure_prob``/``max_retries``/
  ``backoff_s``): every uplink payload segment and the downlink broadcast
  is erased i.i.d. with ``erasure_prob`` per attempt and retransmitted —
  after a ``backoff_s`` radio gap — up to ``max_retries`` times.  The
  attempt count per payload is truncated-geometric; a payload whose every
  attempt is erased is FAILED.  The retransmitted copies become real
  segments of the round's :class:`repro_torch.wireless.timeline.RoundTimeline`,
  so their airtime/energy/bits are priced by the same deadline gate,
  energy charge, and moved-bits ledger as any first transmission.
- **ES outages** (``es_outage_trace``): a round-major 0/1 trace (cycled
  over rounds, resized over ESs) marks edge servers down for whole rounds.
  ``failover="reassoc"`` re-associates a dead ES's clients to the nearest
  live ES (by index distance, ties to the lower index), where they re-enter
  that ES's contention pass; ``failover="skip"`` sits them out.
- **Client crashes** (``crash_hazard``): each round every client draws a
  Bernoulli(``crash_hazard``) crash and a uniform crash INSTANT; a crashed
  client's timeline is truncated at that instant — partial compute and
  partial airtime are charged, partial uplink credits moved bits, exactly
  the PR-7 straggler rules applied at the crash time instead of the
  deadline.

Draw shapes are FIXED per round (every client, every payload slot, every
potential attempt), so the stream position after round ``r`` is a function
of ``r`` alone — never of who was scheduled — which is what makes
checkpoint/resume bit-identical (``ParticipationScheduler.state_dict``
captures the stream).

``FaultConfig()`` defaults encode zero faults; :attr:`FaultConfig.active`
is False and the scheduler never constructs an injector, keeping the
fault-free path bit-identical to the pre-fault scheduler (golden-pinned).

The port's copy of ``repro.wireless.faults``: numpy, as in the reference,
with its imports pointed at the port.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.configs.base import FaultConfig

__all__ = ["FAULT_SEED_OFFSET", "FaultConfig", "FaultPlan", "FaultInjector",
           "expected_attempts"]

# RNG stream allocation (see module docstring): channel = seed, scheduler
# thinning = seed+1, device = seed+2, personalize = seed+3, faults = seed+4
FAULT_SEED_OFFSET = 4

FAILOVER_POLICIES = ("reassoc", "skip")


def expected_attempts(erasure_prob: float, max_retries: int) -> float:
    """Mean transmissions per payload under truncated-geometric HARQ.

    With per-attempt erasure probability ``p`` and at most ``n = 1 +
    max_retries`` attempts, the attempt count is ``min(Geometric(1-p), n)``
    and its mean is ``(1 - p**n) / (1 - p)`` (``n`` at ``p=1``).  The cut
    controller expands its airtime/energy estimates by this factor so
    adaptive policies price retransmissions before they happen.
    """
    p, n = float(erasure_prob), int(max_retries) + 1
    if p <= 0.0:
        return 1.0
    if p >= 1.0:
        return float(n)
    return (1.0 - p ** n) / (1.0 - p)


@dataclass
class FaultPlan:
    """One round's pre-drawn erasure/crash outcomes (fixed shapes).

    Drawn ONCE at the top of ``ParticipationScheduler.step`` and reused by
    every timeline rebuild of the round (contention re-prices the SAME
    erasure fates at different rates), so outcomes never depend on the
    contended rates.
    """
    up_attempts: np.ndarray    # (U, S) int >= 1: transmissions per payload
    up_ok: np.ndarray          # (U, S) bool: payload delivered by its last try
    down_attempts: np.ndarray  # (U,) int >= 1: downlink broadcast attempts
    down_ok: np.ndarray        # (U,) bool: downlink eventually delivered
    crash_frac: np.ndarray     # (U,) float: crash instant as a fraction of
    #                            the deadline (finite) or of the client's own
    #                            activity span (inf deadline); inf = no crash
    backoff_s: float           # radio gap before each retransmission


class FaultInjector:
    """Draws per-round fault plans and resolves ES outages/failover."""

    def __init__(self, cfg: FaultConfig, num_clients: int, n_up_seg: int,
                 num_es: int, seed: int):
        if not 0.0 <= cfg.erasure_prob <= 1.0:
            raise ValueError(f"erasure_prob must be in [0, 1], got "
                             f"{cfg.erasure_prob}")
        if not 0.0 <= cfg.crash_hazard <= 1.0:
            raise ValueError(f"crash_hazard must be in [0, 1], got "
                             f"{cfg.crash_hazard}")
        if cfg.max_retries < 0:
            raise ValueError(f"max_retries must be >= 0, got "
                             f"{cfg.max_retries}")
        if cfg.backoff_s < 0.0:
            raise ValueError(f"backoff_s must be >= 0, got {cfg.backoff_s}")
        if cfg.failover not in FAILOVER_POLICIES:
            raise ValueError(f"unknown failover policy {cfg.failover!r}; "
                             f"one of {FAILOVER_POLICIES}")
        self.cfg = cfg
        self.U = int(num_clients)
        self.S = int(n_up_seg)           # uplink payload slots per client
        self.B = int(num_es)
        self._rng = np.random.default_rng(seed + FAULT_SEED_OFFSET)

    @property
    def needs_plan(self) -> bool:
        """True when per-round timeline faults (erasures/crashes) exist;
        outage-only configs keep the exact fault-free timeline builders."""
        return self.cfg.erasure_prob > 0.0 or self.cfg.crash_hazard > 0.0

    # ------------------------------------------------------------ drawing --
    def round_plan(self) -> FaultPlan | None:
        """Draw one round's erasure fates and crash instants.

        Consumes a FIXED number of draws — (U, S, R+1) uplink uniforms,
        (U, R+1) downlink uniforms, U crash Bernoullis, U crash fractions —
        regardless of scheduling, so the stream position is a pure function
        of the round count (resume-safe).  Returns None when neither
        erasures nor crashes are configured (the rng is not consumed and
        the timeline stays on the exact fault-free builders).
        """
        if not self.needs_plan:
            return None
        cfg, U, S = self.cfg, self.U, self.S
        tries = cfg.max_retries + 1
        up_u = self._rng.random((U, S, tries))
        down_u = self._rng.random((U, tries))
        crash_b = self._rng.random(U)
        crash_f = self._rng.random(U)
        up_att, up_ok = self._attempts(up_u, cfg.erasure_prob)
        down_att, down_ok = self._attempts(down_u[:, None, :],
                                           cfg.erasure_prob)
        crashed = (crash_b < cfg.crash_hazard) if cfg.crash_hazard > 0 \
            else np.zeros(U, bool)
        crash_frac = np.where(crashed, crash_f, np.inf)
        return FaultPlan(up_attempts=up_att, up_ok=up_ok,
                         down_attempts=down_att[:, 0],
                         down_ok=down_ok[:, 0], crash_frac=crash_frac,
                         backoff_s=float(cfg.backoff_s))

    @staticmethod
    def _attempts(uniforms: np.ndarray, p: float):
        """Truncated-geometric attempt counts from per-attempt uniforms.

        Attempt ``j`` is erased iff ``uniforms[..., j] < p``; the payload
        lands on its first non-erased attempt and gives up after the last
        column.  Returns (attempts, ok) dropping the attempt axis.
        """
        erased = uniforms < p
        success = ~erased
        any_ok = success.any(axis=-1)
        first = np.argmax(success, axis=-1)          # 0 when none succeed
        tries = uniforms.shape[-1]
        attempts = np.where(any_ok, first + 1, tries)
        return attempts.astype(int), any_ok

    # ------------------------------------------------------------ outages --
    def es_down(self, round_idx: int) -> np.ndarray | None:
        """(B,) bool outage mask for this round, from the cycled trace.

        Rows cycle modulo the trace length and resize over the B edge
        servers (the same shape rules as the channel's rate traces); no
        trace -> None (no outage machinery at all).
        """
        trace = self.cfg.es_outage_trace
        if not trace:
            return None
        row = np.asarray(trace[round_idx % len(trace)], float)
        return np.resize(row, self.B) > 0.5

    def failover(self, down_b: np.ndarray, es_assign: np.ndarray):
        """Resolve an outage round: (effective es map, skip mask).

        ``reassoc``: each dead ES's clients re-associate to the nearest
        LIVE ES by index distance (ties to the lower index) and re-enter
        that ES's contention; with every ES down nobody can re-associate
        and the whole round is skipped.  ``skip``: a dead ES's clients sit
        the round out (their banked stale pushes pause too — the scheduler
        gates background pushes on a live effective ES).
        """
        es_assign = np.asarray(es_assign, int)
        client_down = down_b[es_assign]
        if not client_down.any():
            return es_assign, np.zeros(len(es_assign), bool)
        live = np.flatnonzero(~down_b)
        if self.cfg.failover == "skip" or len(live) == 0:
            return es_assign, client_down
        # nearest live ES per dead ES; argmin ties break to the lower index
        remap = np.arange(self.B)
        for b in np.flatnonzero(down_b):
            remap[b] = live[np.argmin(np.abs(live - b))]
        return remap[es_assign], np.zeros(len(es_assign), bool)
