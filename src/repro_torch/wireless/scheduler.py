"""Participation scheduling: who makes it into each edge aggregation.

The scheduler composes three gates, applied in order, and emits a 0/1
participation mask per edge round:

1. **energy**  — a client skips any round whose energy it can no longer
   afford (budgets deplete each round the client transmits and never
   recharge; under a fading channel a client priced out of a deep-fade
   round may still afford a later cheap one).  The gate compares the budget
   against the DEADLINE-CAPPED charge the client would actually pay (see
   "timeline straggler semantics" below) — gating on the uncapped full
   airtime would silently bar a client that can afford the capped charge
   while a richer client is scheduled and burns exactly that capped amount;
2. **selection** — an optional scheduling cap: ``topk`` keeps the k
   fastest affordable clients (rate-aware scheduling), ``random`` thins
   them i.i.d. with ``participation_prob`` (unbiased client sampling);
3. **deadline** — a scheduled client completes only if its simulated round
   time (channel latency + its timeline's uplink/downlink/compute activity)
   is within ``deadline_s`` (straggler dropout).

Two optional refinements sit between gates 2 and 3:

- **cut selection** (``cutter``): a :class:`repro_torch.wireless.cutter.
  CutController` picks a per-client cut each round, making the traffic
  (and therefore times, energies, and the deadline outcome) cut-indexed;
- **per-ES contention** (``es_uplink_mbps`` finite): the scheduled clients
  of one ES split its uplink capacity (evenly, or rate-proportionally with
  water-filling under ``contention="proportional"``), so times/energies are
  recomputed at the contended rates, adaptive cut policies re-decide, and
  clients the contended price makes unaffordable withdraw (they never
  transmit, cost nothing, and make nobody wait).  With
  ``reshare_uplink=True`` (default) a SECOND contention pass then re-shares
  the capacity the withdrawn clients freed among the survivors — survivor
  rates can only rise (fewer clients split the same pipe), so no further
  withdrawals are possible and one extra pass suffices; the survivors keep
  the cuts they chose at the first-pass rates (the freed capacity only
  speeds them up).  ``reshare_uplink=False`` reproduces the conservative
  single pass.  Under ``selection="topk"``, a withdrawal no longer silently
  shrinks the round below k: a single BACKFILL pass promotes the
  next-fastest affordable clients (by their pre-contention private times)
  into the freed slots and re-runs the contention round on the refilled
  set — any client the refilled price makes unaffordable (backfilled or
  original) withdraws, and the pass does not iterate further, so the
  round is bounded at two contention rounds and can still end under k if
  the refilled prices bite.

Timeline event model (``repro_torch.wireless.timeline``): every per-client
quantity — completion time, deadline-capped charge, moved bits — is read
off ONE explicit per-client event timeline of compute segments, uplink
segments, and the downlink segment, so the gate, the deduction, and the
ledger can never disagree.  Two timeline shapes exist:

- **serial** (``WirelessConfig.pipeline=False``, default): compute first
  (kappa0 local epochs), then transmit, then receive — the paper's Eq.-17
  model, bit-for-bit identical to the pre-timeline scheduler;
- **pipelined** (``pipeline=True``): the kappa0 x batches_per_epoch
  minibatch activations STREAM — each payload transmits as soon as its
  minibatch's compute finishes and the radio is free, so the uplink
  finishes at ``c + u + (n-1)*max(c, u) + tail`` instead of ``n*c + n*u +
  tail`` (per-chunk compute c, per-payload airtime u): pipelining saves
  exactly ``(n-1)*min(c, u) >= 0`` and the round time moves from
  ``compute + tx`` toward ``max(compute, tx)`` plus one fill bubble.

Timeline straggler semantics (the single source of truth for gate, charge,
and traffic accounting): activity segments are LATENCY-FREE — latency is
charged on the round CLOCK (``times_s``), not against the transmit window,
so the capped window slightly over-credits a straggler whose deadline
slack is mostly propagation delay.  A deadline at ``T`` freezes the
timeline at ``T``: each segment is charged its overlap with ``[0, T)``, so

    compute_charged_s = min(total compute, T)
    tx_charged_s      = sum over uplink segments of their overlap with T
    down_window_s     = overlap of the downlink segment with T

(serial: ``tx_charged_s = min(uplink airtime, max(T - compute, 0))``
exactly as before; pipelined: the per-segment sum credits the airtime
actually spent under the overlapped schedule) and the energy charge is
``compute_power_w * compute_charged_s + tx_power_w * tx_charged_s`` — paid
by EVERY scheduled client, deadline-missing stragglers included (their
update is discarded, unless staleness banking folds it in late — below).
The energy gate admits exactly the clients whose budget covers this
charge, so the gate and the deduction can never disagree and budgets never
go negative.  A client that could not push a single uplink bit before the
cutoff (serial: compute alone eats the window; pipelined: even the FIRST
chunk's compute does) is never scheduled at all: scheduling it would only
burn a contention share and pin the round clock at the deadline.
``RoundReport.bits_tx`` counts the bits that actually MOVED, both ways: a
straggler counts ``uplink_bps * tx_charged_s`` uplink bits plus
``downlink_bps * down_window_s`` downlink bits (a client cut mid-downlink
is credited the partial broadcast it did receive — the downlink twin of
the pro-rated uplink credit).

Staleness banking (``WirelessConfig.staleness_lambda > 0``): a deadline-cut
straggler's undelivered uplink remainder is BANKED (``uplink bits -
moved uplink bits``) instead of discarded.  In each later round the banked
client is idle (unscheduled), its radio background-pushes the remainder at
its PRIVATE rate inside that round's wall-clock window, energy-gated and
energy-charged like any transmission; when the remainder reaches zero the
update is DELIVERED at staleness ``s`` = the number of edge rounds since
it was banked (``RoundReport.stale_delivered[u] = s``, always >= 1), and
``repro_torch.core.fedsim`` folds the banked model into that round's edge
aggregation with weight ``alpha_u * lambda**s``.  A bank dies without
delivering when its client completes a FRESH round (the fresh update
supersedes it) or straggles again (the new remainder replaces it) —
``RoundReport.stale_dropped``.  ``staleness_lambda=0`` (default) disables
the machinery entirely and reproduces the hard-dropout scheduler
bit-for-bit.

The simulated edge-round wall clock is the slowest scheduled client's time
when every scheduled client made the deadline, else the full deadline (the
ES waits it out).  Clients the scheduler never scheduled (energy, top-k,
thinning) cost no waiting, and background stale pushes ride inside the
existing window.

Failure semantics (``WirelessConfig.faults``; repro_torch.wireless.faults):

- **Erasures + HARQ**: every uplink payload and the downlink broadcast is
  erased i.i.d. per attempt with ``erasure_prob`` and retransmitted (after
  ``backoff_s`` of radio idle) up to ``max_retries`` times.  Retransmitted
  copies are ordinary timeline segments, so the deadline gate, the energy
  charge, and the moved-bits ledger price them with the SAME freeze rule
  as first transmissions; ``RoundReport.bits_tx`` counts AIR bits (every
  attempt), and ``retx_bits``/``retx_j`` isolate the overhead beyond the
  first attempts.  A client whose payload exhausts its retries is FAILED
  (``RoundReport.failed``): not alive, but with ``staleness_lambda > 0``
  its NOT-yet-delivered remainder (nominal bits minus erasure-survived
  goodput) flows into the stale bank and can still land late — graceful
  means "late and discounted", never "silently lost".  A client that
  delivered its uplink but lost every downlink attempt (``down_failed``)
  still participates in the aggregation (the ES has its update) but keeps
  its own local model instead of the refreshed edge model (the FedSim
  fold).
- **ES outage + failover**: ``es_outage_trace`` marks whole ESs down for
  whole rounds (``RoundReport.es_down``).  ``failover="reassoc"`` moves
  the dead ES's clients to the nearest live ES (``RoundReport.es_map``),
  where they re-enter that ES's contention pass and join ITS aggregation;
  ``"skip"`` sits them out (never scheduled, cost nothing).  Banked stale
  pushes pause while the client's effective ES is down.  A dead ES's edge
  model is simply carried forward by FedSim's existing zero-participant
  fallback.
- **Client crash**: with probability ``crash_hazard`` per round, a
  scheduled client dies at a uniform instant; its timeline freezes at
  ``min(deadline, crash instant)`` — partial compute charged, partial
  uplink credited as moved bits, exactly the straggler freeze applied at
  the crash cap (``RoundReport.crashed``).  A crashed client loses its
  local state, so its remainder is NOT banked (unlike a straggler or an
  erasure failure).  The energy gate admits on the SAME crash-capped
  charge it deducts, preserving gate == deduction (the simulator is
  omniscient about its own fault draws; a conservative no-crash gate
  would break that invariant).
- ``FaultConfig()`` (all defaults) builds no injector at all: every code
  path above is skipped and the scheduler is bit-identical to the
  fault-free one (golden-pinned).  Fault draws come from the dedicated
  ``seed+4`` stream with FIXED per-round shapes, so enabling faults never
  perturbs fading/thinning draws and checkpoint/resume (``state_dict`` /
  ``load_state_dict``) replays the exact fault schedule.

Oracle contract (population-scale twin): this numpy scheduler is the
REFERENCE ORACLE for the vectorized cohort path — ``repro_torch.wireless.
population.CohortScheduler`` re-derives the same per-round decisions as
float64 torch tensor code on a device (``repro_torch.wireless.
scheduler_core``) and must reproduce this class's :class:`RoundReport`
BIT-IDENTICALLY on every fault-free (and outage-only) configuration;
rounds with an erasure/crash fault plan are delegated back to this
implementation.  The equivalence is pinned by the U=8 property test in
``tests/test_torch_cohort.py`` across channel models, contention rules,
pipeline on/off, selection policies, and fault-injected rounds.  When changing any per-round
expression here, keep ``scheduler_core`` in lockstep (or the property
test will say so).  ``cohort_mask`` (set per round by CohortScheduler,
None otherwise) restricts gate 1 to a sampled cohort; the default None
leaves this class's behavior byte-for-byte unchanged.

The port's copy of ``repro.wireless.scheduler``: numpy, as in the
reference, with its imports pointed at the port, its telemetry hook
(``repro_torch.telemetry``) included.
"""

from __future__ import annotations

from dataclasses import dataclass, fields

import numpy as np

from repro_torch.configs.base import WirelessConfig
from repro_torch.wireless.channel import ChannelModel, LinkState, RoundBits
from repro_torch.wireless.device import DeviceModel
from repro_torch.wireless.faults import FaultInjector
from repro_torch.wireless.timeline import RoundTimeline, build_timeline


@dataclass
class RoundReport:
    """What the network did in one edge round."""
    round_idx: int
    mask: np.ndarray           # (U,) float64 in {0, 1}
    times_s: np.ndarray        # (U,) per-client completion time (compute +
    #                            latency + airtime)
    round_time_s: float        # simulated wall clock of this edge round
    energy_left_j: np.ndarray  # (U,) remaining budgets AFTER this round
    scheduled: np.ndarray = None   # (U,) bool: transmitted this round
    cuts: np.ndarray = None        # (U,) int cut indices (None: fixed bits)
    uplink_bps: np.ndarray = None  # (U,) effective (contended) uplink rates
    codecs: np.ndarray = None      # (U,) int codec indices into the
    #                                controller's codec_names (None unless a
    #                                cut x codec grid is in play)
    bits_tx: float = 0.0           # total bits actually MOVED this round by
    #                                scheduled clients (a deadline-cut
    #                                straggler counts the uplink bits it
    #                                pushed and the downlink bits it received
    #                                before the cutoff) plus background
    #                                stale-bank pushes
    compute_s: np.ndarray = None   # (U,) per-client local compute time of
    #                                this round's workload (device model)
    compute_j: np.ndarray = None   # (U,) compute joules actually charged
    #                                (zero for unscheduled clients)
    stale_banked: np.ndarray = None     # (U,) bool: this round's straggler
    #                                remainder was banked for late delivery
    #                                (None unless staleness_lambda > 0)
    stale_delivered: np.ndarray = None  # (U,) int: a banked update finished
    #                                arriving this round, value = staleness
    #                                in edge rounds (0 = nothing delivered)
    stale_dropped: np.ndarray = None    # (U,) bool: a bank died unfolded
    #                                (superseded by a fresh round or
    #                                replaced by a newer straggle)
    crashed: np.ndarray = None     # (U,) bool: died mid-round at the crash
    #                                cap (None unless erasures/crashes on)
    failed: np.ndarray = None      # (U,) bool: an uplink payload exhausted
    #                                its HARQ retries (update never arrived)
    down_failed: np.ndarray = None  # (U,) bool: alive (uplink delivered)
    #                                but every downlink attempt was lost —
    #                                FedSim keeps this client's local model
    es_down: np.ndarray = None     # (B,) bool outage mask of this round
    #                                (None: no outage this round)
    es_map: np.ndarray = None      # (U,) int effective ES after failover
    #                                (None except reassoc outage rounds)
    retx_bits: float = 0.0         # air bits beyond first attempts (HARQ
    #                                overhead; included in bits_tx)
    retx_j: float = 0.0            # transmit joules beyond first attempts

    # dtypes for from_json_dict (JSON erases them); absent keys default to
    # float.  NOT a dataclass field (no annotation).
    _DTYPES = {"mask": np.float64, "scheduled": bool, "cuts": int,
               "codecs": int, "stale_banked": bool, "stale_delivered": int,
               "stale_dropped": bool, "crashed": bool, "failed": bool,
               "down_failed": bool, "es_down": bool, "es_map": int}

    @property
    def num_participants(self) -> int:
        return int(self.mask.sum())

    @property
    def mean_cut(self) -> float | None:
        """Mean cut position of the clients that actually transmitted (all
        clients when nobody did — their entries are the hypothetical
        private-rate picks).  None without a cut controller."""
        if self.cuts is None:
            return None
        sel = (self.scheduled if self.scheduled is not None
               and self.scheduled.any() else np.ones(len(self.cuts), bool))
        return float(self.cuts[sel].mean())

    def to_json_dict(self) -> dict:
        """JSON-safe dict: every field (ndarrays -> lists) plus the derived
        ``participants`` and ``mean_cut`` the sweep benchmarks table.  The
        inverse is :meth:`from_json_dict`."""
        out = {}
        for f in fields(self):
            v = getattr(self, f.name)
            if isinstance(v, np.ndarray):
                v = v.tolist()
            elif isinstance(v, (np.floating, np.integer, np.bool_)):
                v = v.item()
            out[f.name] = v
        out["participants"] = self.num_participants
        out["mean_cut"] = self.mean_cut
        return out

    @classmethod
    def from_json_dict(cls, d: dict) -> "RoundReport":
        """Rebuild a report from :meth:`to_json_dict` output (derived keys
        are ignored; list fields come back as arrays of their native
        dtype)."""
        kw = {}
        for f in fields(cls):
            if f.name not in d:
                continue
            v = d[f.name]
            if isinstance(v, list):
                v = np.asarray(v, cls._DTYPES.get(f.name, float))
            kw[f.name] = v
        return cls(**kw)


class ParticipationScheduler:
    """Stateful per-edge-round participation decisions for U clients."""

    def __init__(self, cfg: WirelessConfig, channel: ChannelModel,
                 bits: RoundBits | None = None, *, cutter=None,
                 es_assign: np.ndarray | None = None,
                 device: DeviceModel | None = None, flops: float = 0.0,
                 telemetry=None):
        if cfg.selection not in ("deadline", "topk", "random"):
            raise ValueError(f"unknown selection policy {cfg.selection!r}")
        if (bits is None) == (cutter is None):
            raise ValueError("pass exactly one of bits= or cutter=")
        if not 0.0 <= cfg.staleness_lambda <= 1.0:
            raise ValueError(f"staleness_lambda must be in [0, 1], got "
                             f"{cfg.staleness_lambda}")
        self.cfg = cfg
        self.channel = channel
        self.bits = bits
        self.cutter = cutter
        self.U = channel.U
        # device (compute) model; ``flops`` is the fixed-bits path's per-round
        # client workload (the cutter path carries per-cell FLOPs itself)
        self.device = device if device is not None else DeviceModel(cfg,
                                                                    self.U)
        self.flops = flops
        # ES attachment for the shared-uplink contention; default: one pool
        self.es_assign = (np.zeros(self.U, int) if es_assign is None
                          else np.asarray(es_assign, int))
        assert self.es_assign.shape == (self.U,)
        self.energy_left = np.full(self.U, cfg.energy_budget_j)
        self._rng = np.random.default_rng(cfg.seed + 1)
        # staleness banking state: the undelivered uplink remainder of each
        # client's last straggle, and its age in edge rounds (-1 = no bank)
        self._stale_pending = np.zeros(self.U)
        self._stale_age = np.full(self.U, -1)
        # fault injection (module docstring "Failure semantics"); the
        # all-defaults FaultConfig builds NO injector and every fault code
        # path below is skipped (bit-identity to the fault-free scheduler)
        self.injector = None
        if cfg.faults.active:
            chunks = (self.cutter.chunks if self.cutter is not None
                      else int(bits.chunks))
            n_seg = (int(chunks) + 1) if cfg.pipeline else 1
            self.injector = FaultInjector(
                cfg.faults, self.U, n_seg,
                int(self.es_assign.max()) + 1, cfg.seed)
        self._plan = None                  # this round's FaultPlan (or None)
        self._es_eff = self.es_assign      # effective ES map after failover
        # observability (repro_torch.telemetry): a purely-read-only
        # observer of each round's report + timeline.  None (the default,
        # enforced by reprolint's telemetry-off-default) skips every hook —
        # no file I/O, no RNG, no arithmetic on scheduler state
        self.telemetry = telemetry
        self.last_timeline = None          # the most recent step's timeline
        # cohort restriction (population-scale runs): a (U,) bool mask
        # ANDed into gate 1 each round, so only the sampled cohort can be
        # scheduled while everyone else's state (energy, banks) advances.
        # None (the default) is byte-for-byte the unrestricted scheduler.
        self.cohort_mask = None

    def _bits_cuts(self, up_bps, down_bps, latency_s):
        """Cut decision (or the fixed bits) at the given rates."""
        if self.cutter is None:
            return self.bits, None
        cuts = self.cutter.decide(up_bps, down_bps, latency_s,
                                  self.energy_left,
                                  self.device.sec_per_flop)
        return self.cutter.bits_for(cuts), cuts

    def _compute_s(self, cuts) -> np.ndarray:
        """Per-client local compute time of this round's workload."""
        flops = self.flops if cuts is None else self.cutter.flops_for(cuts)
        return np.broadcast_to(self.device.compute_time_s(flops), (self.U,))

    def _timeline(self, link: LinkState, bits: RoundBits,
                  comp_s: np.ndarray) -> RoundTimeline:
        """The round's per-client event timeline at the given rates — the
        single source of truth for times, charges, and moved bits (module
        docstring's timeline straggler semantics).  ``self._plan`` (drawn
        once at the top of ``step``) routes fault rounds to the HARQ/crash
        builder; every rebuild of the round re-prices the SAME fates."""
        return build_timeline(link, bits, comp_s, self.cfg.deadline_s,
                              self.U, pipeline=self.cfg.pipeline,
                              plan=self._plan)

    def _contend(self, private: LinkState, scheduled: np.ndarray, bits, cuts,
                 comp_s, tl: RoundTimeline):
        """One full contention round over the ``scheduled`` set.

        Shares the per-ES pipe, lets adaptive cut policies re-decide at the
        contended rates, withdraws clients the contended price makes
        unaffordable, and (``reshare_uplink``) re-shares their freed
        capacity among the survivors.  Returns the (possibly shrunk)
        scheduled set plus everything priced at the final rates; a bypassed
        contention (ideal channel / infinite capacity) returns the inputs
        untouched with ``contended=False``.
        """
        cfg = self.cfg
        link = private
        eff_up = self.channel.contended_uplink(private, scheduled,
                                               self._es_eff)
        if eff_up is private.uplink_bps:
            return (link, bits, cuts, comp_s, tl, scheduled,
                    np.zeros(self.U, bool), False)
        link = LinkState(eff_up, private.downlink_bps, private.latency_s)
        if self.cutter is not None and self.cutter.policy != "fixed":
            # adaptive policies re-decide at the rate actually available
            bits2, cuts2 = self._bits_cuts(eff_up, link.downlink_bps,
                                           link.latency_s)
            cuts = np.where(scheduled, cuts2, cuts)
            bits = self.cutter.bits_for(cuts)
            comp_s = self._compute_s(cuts)
        tl = self._timeline(link, bits, comp_s)
        charge = tl.charge_j(cfg.tx_power_w, cfg.compute_power_w)
        # the contended price can only be higher; a client that can no
        # longer afford it (or whose re-decided cut left it no transmit
        # window) withdraws before transmitting
        ok = (self.energy_left >= charge) & tl.can_tx
        withdrawn = scheduled & ~ok
        scheduled = scheduled & ok
        if cfg.reshare_uplink and withdrawn.any() and scheduled.any():
            # second pass: survivors absorb the capacity the withdrawn
            # clients freed.  Rates can only rise (fewer clients share
            # the same pipe), so times/energies only fall and no new
            # withdrawal is possible; the survivors keep their
            # first-pass cut/codec choices.
            eff_up = self.channel.contended_uplink(private, scheduled,
                                                   self._es_eff)
            link = LinkState(eff_up, private.downlink_bps,
                             private.latency_s)
            tl = self._timeline(link, bits, comp_s)
        return link, bits, cuts, comp_s, tl, scheduled, withdrawn, True

    def step(self, round_idx: int) -> RoundReport:
        cfg = self.cfg
        link = self.channel.sample(round_idx)
        private = link
        # ---- fault round state (module docstring "Failure semantics"):
        # erasure fates and crash instants are drawn ONCE, before any
        # timeline, so contention re-pricing re-uses the same outcomes;
        # an ES outage remaps (reassoc) or sidelines (skip) its clients
        self._plan = None
        self._es_eff = self.es_assign
        es_down = None
        client_down = None
        if self.injector is not None:
            self._plan = self.injector.round_plan()
            es_down = self.injector.es_down(round_idx)
            if es_down is not None and es_down.any():
                self._es_eff, client_down = self.injector.failover(
                    es_down, self.es_assign)
            else:
                es_down = None
        bits, cuts = self._bits_cuts(link.uplink_bps, link.downlink_bps,
                                     link.latency_s)
        comp_s = self._compute_s(cuts)
        tl = self._timeline(link, bits, comp_s)
        charge = tl.charge_j(cfg.tx_power_w, cfg.compute_power_w)
        times0 = tl.times_s                     # private-rate times (topk)

        # gate 1: energy (deadline-capped charge) + a transmit window at all
        gate1 = (self.energy_left >= charge) & tl.can_tx
        if client_down is not None:
            gate1 &= ~client_down        # outage-skipped: never scheduled
        if self.cohort_mask is not None:
            gate1 &= self.cohort_mask    # population runs: sampled cohort
        scheduled = gate1.copy()
        if cfg.selection == "topk" and cfg.topk > 0:     # gate 2a: k fastest
            order = np.argsort(np.where(scheduled, times0, np.inf))
            keep = np.zeros(self.U, bool)
            keep[order[:cfg.topk]] = True
            scheduled &= keep
        elif cfg.selection == "random" and cfg.participation_prob < 1.0:
            scheduled &= self._rng.random(self.U) < cfg.participation_prob

        # ---- per-ES uplink contention among the scheduled clients ----
        bits0, cuts0, comp0, tl0 = bits, cuts, comp_s, tl
        (link, bits, cuts, comp_s, tl, scheduled, withdrawn,
         contended) = self._contend(private, scheduled, bits, cuts, comp_s,
                                    tl)
        n_backfilled = 0
        if (contended and cfg.selection == "topk" and cfg.topk > 0
                and int(scheduled.sum()) < cfg.topk):
            # topk BACKFILL (single pass, see module docstring): promote the
            # next-fastest affordable never-withdrawn clients into the freed
            # slots and re-run the contention round on the refilled set
            pool = gate1 & ~scheduled & ~withdrawn
            if pool.any():
                order = np.argsort(np.where(pool, times0, np.inf))
                extra = np.zeros(self.U, bool)
                extra[order[:cfg.topk - int(scheduled.sum())]] = True
                extra &= pool
                if extra.any():
                    (link, bits, cuts, comp_s, tl, scheduled, withdrawn,
                     _) = self._contend(private, scheduled | extra, bits0,
                                        cuts0, comp0, tl0)
                    n_backfilled = int((scheduled & extra).sum())
        times = tl.times_s
        charge = tl.charge_j(cfg.tx_power_w, cfg.compute_power_w)

        alive = scheduled & (times <= cfg.deadline_s)    # gate 3: deadline
        crashed = failed = down_failed = None
        if self._plan is not None:
            # gates 3b/3c: a crashed or HARQ-exhausted client's update never
            # arrives; a lost downlink does NOT kill participation (the ES
            # holds the uplink — the client just keeps its local model)
            crashed = scheduled & tl.crashed
            failed = scheduled & ~tl.crashed & ~self._plan.up_ok.all(axis=1)
            alive &= tl.up_ok_all & ~tl.crashed
            down_failed = alive & ~tl.down_ok

        # every scheduled client pays the deadline-capped charge (compute
        # joules + transmit joules) — the SAME quantity the energy gate
        # admitted it on, so the budget can never go negative (crash rounds:
        # the charge is already crash-capped, gate == deduction still)
        self.energy_left = np.where(scheduled, self.energy_left - charge,
                                    self.energy_left)

        if self._plan is not None:
            # fault rounds: the ES waits the deadline out only for a
            # DEADLINE straggler; a crashed client goes silent at its cap
            # and a HARQ failure finishing early ends with its last attempt
            if not scheduled.any():
                round_time = 0.0
            else:
                strag = scheduled & ~tl.crashed & (times > cfg.deadline_s)
                if strag.any() and np.isfinite(cfg.deadline_s):
                    round_time = float(cfg.deadline_s)
                else:
                    eff_end = np.where(
                        tl.crashed, 2 * link.latency_s + tl.cap_s, times)
                    t = eff_end[scheduled].max()
                    round_time = float(t) if np.isfinite(t) else 0.0
        elif not alive.any():
            # a scheduled-but-straggling client still makes the ES wait
            round_time = (float(cfg.deadline_s)
                          if scheduled.any() and np.isfinite(cfg.deadline_s)
                          else 0.0)
        elif (scheduled & ~alive).any():
            round_time = float(cfg.deadline_s)           # ES waits it out
        else:
            t = times[alive].max()
            round_time = float(t) if np.isfinite(t) else 0.0
        # translate internal candidate-cell indices into cut depth / codec
        # positions so the report reads "which split, which codec", and sum
        # the bits that actually MOVED off the timeline: a completing client
        # moved its full up+down traffic, a deadline-cut straggler the
        # uplink bits it pushed (uplink_bps * tx_charged_s) and the downlink
        # bits it received (downlink_bps * down_window_s) before the cutoff
        rep_cuts = rep_codecs = None
        if cuts is not None:
            rep_cuts = self.cutter.cut_pos[cuts]
            if self.cutter.has_codec_grid:
                rep_codecs = self.cutter.codec_pos[cuts]
        up = np.broadcast_to(np.asarray(bits.uplink, float), (self.U,))
        down = np.broadcast_to(np.asarray(bits.downlink, float), (self.U,))
        up_rate = np.broadcast_to(np.asarray(link.uplink_bps, float),
                                  (self.U,))
        down_rate = np.broadcast_to(np.asarray(link.downlink_bps, float),
                                    (self.U,))
        tx_s, down_win = tl.tx_charged_s, tl.down_window_s
        retx_bits = retx_j = 0.0
        if self._plan is not None:
            # AIR accounting: every HARQ attempt moves bits (that's what the
            # radio transmitted); a cap-truncated client credits rate x its
            # charged airtime — the same freeze rule as first transmissions.
            # The retransmit overhead is the airtime beyond FIRST attempts
            # (``tl.first_tx_s``), priced in bits and transmit joules.
            with np.errstate(invalid="ignore"):  # ideal channel: inf * 0
                moved_up = np.where(tl.up_done, tl.air_up_bits,
                                    np.where(tx_s > 0, up_rate * tx_s, 0.0))
                moved_down = np.where(tl.down_done, tl.air_down_bits,
                                      np.where(down_win > 0,
                                               down_rate * down_win, 0.0))
                d_up = np.maximum(tx_s - tl.first_tx_s, 0.0)
                d_down = np.maximum(down_win - tl.first_down_s, 0.0)
                retx_up = np.where(tl.up_done, tl.air_up_bits - up,
                                   np.where(d_up > 0, up_rate * d_up, 0.0))
                retx_down = np.where(tl.down_done, tl.air_down_bits - down,
                                     np.where(d_down > 0,
                                              down_rate * d_down, 0.0))
            retx_bits = float((retx_up + retx_down)[scheduled].sum())
            retx_j = float(cfg.tx_power_w
                           * (d_up + d_down)[scheduled].sum())
            # the stale bank holds what was never DELIVERED (nominal minus
            # erasure-survived goodput), not what was never transmitted
            bank_up = tl.goodput_up_bits
        else:
            with np.errstate(invalid="ignore"):      # ideal channel: inf * 0
                moved_up = np.where(alive, up,
                                    np.where(tx_s > 0, up_rate * tx_s, 0.0))
                moved_down = np.where(alive, down,
                                      np.where(down_win > 0,
                                               down_rate * down_win, 0.0))
            bank_up = moved_up
        moved = moved_up + moved_down
        bits_tx = float(moved[scheduled].sum())

        # ---- staleness banking (module docstring; lambda=0: no machinery)
        stale_banked = stale_delivered = stale_dropped = None
        if cfg.staleness_lambda > 0.0:
            stale_banked, stale_delivered, stale_dropped, bg_bits = \
                self._stale_update(
                    private, scheduled, alive, up, bank_up, round_time,
                    push_ok=(None if es_down is None
                             else ~es_down[self._es_eff]),
                    bankable=None if self._plan is None else ~tl.crashed)
            bits_tx += bg_bits

        compute_j = np.where(scheduled,
                             cfg.compute_power_w * tl.compute_charged_s, 0.0)
        es_map = (self._es_eff.copy()
                  if es_down is not None
                  and not np.array_equal(self._es_eff, self.es_assign)
                  else None)
        rep = RoundReport(round_idx=round_idx, mask=alive.astype(np.float64),
                          times_s=times, round_time_s=round_time,
                          energy_left_j=self.energy_left.copy(),
                          scheduled=scheduled.copy(), cuts=rep_cuts,
                          uplink_bps=np.asarray(link.uplink_bps).copy(),
                          codecs=rep_codecs, bits_tx=bits_tx,
                          compute_s=np.asarray(comp_s, float).copy(),
                          compute_j=compute_j, stale_banked=stale_banked,
                          stale_delivered=stale_delivered,
                          stale_dropped=stale_dropped,
                          crashed=crashed, failed=failed,
                          down_failed=down_failed,
                          es_down=None if es_down is None
                          else es_down.copy(),
                          es_map=es_map, retx_bits=retx_bits, retx_j=retx_j)
        self.last_timeline = tl
        tel = self.telemetry
        if tel is not None and getattr(tel, "enabled", False):
            has_bank = self._stale_age >= 0
            tel.record_round(
                rep, tl, es_assign=self._es_eff,
                deadline_s=float(cfg.deadline_s),
                withdrawn=int(withdrawn.sum()),
                backfilled=n_backfilled,
                tx_j=float(cfg.tx_power_w * tl.tx_charged_s[scheduled].sum()),
                bank_depth=int(has_bank.sum()),
                bank_age_max=(int(self._stale_age[has_bank].max())
                              if has_bank.any() else 0))
        return rep

    def _stale_update(self, private: LinkState, scheduled, alive, up,
                      moved_up, round_time: float, *, push_ok=None,
                      bankable=None):
        """One round of the staleness bank's state machine.

        Ages every bank; background-pushes idle banks' remainders at the
        clients' PRIVATE rates inside this round's wall-clock window
        (energy-gated and charged like any transmission); marks banks
        DELIVERED when the remainder reaches zero; drops banks a fresh
        completion supersedes; banks this round's new straggler remainders
        (replacing any older bank).  Returns the three (U,) report arrays
        plus the background bits moved.

        Fault hooks: ``push_ok`` (a (U,) bool, default all-True) pauses
        background pushes whose effective ES is down this round (the bank
        survives, aging); ``bankable`` masks out clients whose remainder
        must NOT be banked (a crashed client lost its local state).  On a
        fault round ``moved_up`` is the GOODPUT (delivered nominal bits),
        so the remainder banked is exactly what never arrived.
        """
        cfg, U = self.cfg, self.U
        stale_banked = np.zeros(U, bool)
        stale_delivered = np.zeros(U, int)
        stale_dropped = np.zeros(U, bool)
        bg_bits = 0.0
        has_bank = self._stale_age >= 0
        if has_bank.any():
            self._stale_age = np.where(has_bank, self._stale_age + 1,
                                       self._stale_age)
            superseded = has_bank & alive    # a fresh update landed instead
            idle = has_bank & ~scheduled     # radio free: background push
            if push_ok is not None:
                idle &= push_ok              # effective ES down: push waits
            rate = np.broadcast_to(np.asarray(private.uplink_bps, float),
                                   (U,))
            with np.errstate(divide="ignore", invalid="ignore"):
                need = self._stale_pending / rate
            need = np.where(np.isfinite(need), need, 0.0)
            afford = (self.energy_left / cfg.tx_power_w
                      if cfg.tx_power_w > 0 else np.full(U, np.inf))
            air = np.minimum(np.minimum(need, round_time), afford)
            air = np.where(idle, np.maximum(air, 0.0), 0.0)
            with np.errstate(invalid="ignore"):  # ideal channel: inf * 0
                moved_bg = np.where(air >= need, self._stale_pending,
                                    np.where(air > 0, rate * air, 0.0))
            moved_bg = np.where(idle, moved_bg, 0.0)
            # air <= budget/power by construction; the maximum() only mops
            # up the one-ulp rounding of power * (budget / power)
            self.energy_left = np.where(
                air > 0,
                np.maximum(self.energy_left - cfg.tx_power_w * air, 0.0),
                self.energy_left)
            self._stale_pending = self._stale_pending - moved_bg
            bg_bits = float(moved_bg.sum())
            delivered = idle & (self._stale_pending <= 0.0)
            stale_delivered = np.where(delivered, self._stale_age, 0)
            stale_dropped |= superseded
            clear = delivered | superseded
            self._stale_age = np.where(clear, -1, self._stale_age)
            self._stale_pending = np.where(clear, 0.0, self._stale_pending)
        strag = scheduled & ~alive
        if bankable is not None:
            strag &= bankable                # crashed: nothing left to bank
        if strag.any():
            # a newer straggle replaces any surviving older bank
            stale_dropped |= strag & (self._stale_age >= 0)
            remainder = np.maximum(up - moved_up, 0.0)
            self._stale_pending = np.where(strag, remainder,
                                           self._stale_pending)
            self._stale_age = np.where(strag, 0, self._stale_age)
            stale_banked |= strag
        return stale_banked, stale_delivered, stale_dropped, bg_bits

    # ------------------------------------------------------ checkpointing --
    def state_dict(self) -> dict:
        """Everything mutable, as flat numpy arrays (checkpoint-ready):
        energy budgets, the staleness bank, and every RNG stream the
        scheduler's trajectory depends on (thinning, channel fading, fault
        draws).  ``load_state_dict`` on a freshly built scheduler of the
        same config resumes the trajectory bit-identically."""
        from repro_torch.checkpoint.rng import rng_state_array
        out = {"energy_left_j": self.energy_left.copy(),
               "stale_pending": self._stale_pending.copy(),
               "stale_age": self._stale_age.copy(),
               "rng": rng_state_array(self._rng),
               "channel_rng": rng_state_array(self.channel._rng)}
        if self.injector is not None:
            out["fault_rng"] = rng_state_array(self.injector._rng)
        return out

    def load_state_dict(self, state: dict) -> None:
        from repro_torch.checkpoint.rng import restore_rng_state
        self.energy_left = np.asarray(state["energy_left_j"], float).copy()
        self._stale_pending = np.asarray(state["stale_pending"],
                                         float).copy()
        self._stale_age = np.asarray(state["stale_age"], int).copy()
        restore_rng_state(self._rng, state["rng"])
        restore_rng_state(self.channel._rng, state["channel_rng"])
        if self.injector is not None:
            if "fault_rng" not in state:
                raise ValueError("checkpoint has no fault RNG state but "
                                 "faults are configured — resuming would "
                                 "fork the fault schedule")
            restore_rng_state(self.injector._rng, state["fault_rng"])
