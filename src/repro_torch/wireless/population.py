"""Population-scale cohort simulation: 10**5..10**6 registered clients.

The PyTorch rendering of ``repro.wireless.population``: the registry,
k-means and cohort sampling are the reference's numpy, on the host; the
two decision stages of a round run as float64 tensor code on a device
(``core_device``: the card unless the CPU is asked for).

The paper's premise is massive numbers of wireless clients, but the
oracle :class:`~repro_torch.wireless.scheduler.ParticipationScheduler` walks
host-side numpy expressions sized for U=8 study runs.  This module is the
population-scale twin:

- :class:`Population` — a struct-of-arrays registry of every client the
  simulation knows: packed per-client coordinates, ES assignment
  (round-robin or k-means location clusters), data-skew sizes, a
  personalized-head pointer, and a participation counter, plus per-round
  cohort SAMPLING (``uniform`` / ``rate``-biased / ``pareto``
  participation-capped) from the dedicated ``seed + 5`` stream (disjoint
  from channel ``seed``, thinning ``+1``, device ``+2``, personalize
  ``+3``, faults ``+4`` — enabling populations never perturbs them);
- :class:`CohortScheduler` — a drop-in ``ParticipationScheduler`` subclass
  whose ``step()`` re-derives the per-round decision path as the two
  float64 device stages of :mod:`repro_torch.wireless.scheduler_core`
  (rates -> cut grid argmin -> timeline aggregates -> gates -> contention
  -> withdrawal/reshare -> ledger), with only the selection gate (whose
  ``np.argsort`` quicksort tie order is host semantics) between them.

Bit-identity contract: on every fault-free and ES-outage-only
configuration the vectorized step returns a :class:`~repro_torch.wireless.
scheduler.RoundReport` BIT-IDENTICAL to the numpy oracle's — same rates,
same cuts, same masks, same energies, same ledger sums — pinned by
``tests/test_torch_cohort.py`` at U=8 on the CPU and by
``chip_smoke.check_cohort`` on the card, also at 10**5 clients.  Rounds
that carry an erasure/crash fault plan (data-dependent HARQ attempt
shapes) delegate to the inherited oracle ``step()`` verbatim; both paths
share every piece of mutable state (energy budgets, stale bank, RNG
streams), so a run may interleave them freely.

Scale: the per-round cost is two device stages over (N,) tensors plus
an O(N) host step: the selection gate, the report's copies and its numpy
totals.  Budgets stay numpy on the host between rounds, the state both
paths share; each round copies them in with the round's fading draws.
The telemetry trace exporter (which materializes per-client event
segments) is priced accordingly: with telemetry enabled the round builds
the host timeline from the stages' outputs and records it; without it
(the default) ``last_timeline`` stays None.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import WirelessConfig
from repro_torch.device import resolve_device
from repro_torch.wireless import scheduler_core as core
from repro_torch.wireless.channel import LinkState
from repro_torch.wireless.scheduler import ParticipationScheduler, RoundReport


# --------------------------------------------------------------- k-means --
def kmeans_assign(coords: np.ndarray, k: int, rng, iters: int = 25):
    """Seeded Lloyd's k-means over client coordinates -> (labels, centers).

    Deterministic in ``rng``: k-means++ seeding (first center uniform,
    each next center D**2-weighted away from the chosen ones), then Lloyd
    iterations; an emptied cluster re-seeds at the worst-served client.
    Small fixed iteration count — ES placement is scenario geometry, not
    an optimizer.
    """
    coords = np.asarray(coords, float)
    k = int(k)
    centers = coords[[rng.integers(len(coords))]]
    for _ in range(k - 1):
        d2 = ((coords[:, None, :] - centers[None, :, :]) ** 2
              ).sum(axis=-1).min(axis=1)
        tot = d2.sum()
        p = d2 / tot if tot > 0 else np.full(len(coords), 1 / len(coords))
        centers = np.concatenate(
            [centers, coords[[rng.choice(len(coords), p=p)]]])
    labels = np.zeros(len(coords), int)
    for _ in range(int(iters)):
        d = ((coords[:, None, :] - centers[None, :, :]) ** 2).sum(axis=-1)
        labels = d.argmin(axis=1)
        for b in range(k):
            sel = labels == b
            if sel.any():
                centers[b] = coords[sel].mean(axis=0)
            else:
                centers[b] = coords[d.min(axis=1).argmax()]
    return labels, centers


class Population:
    """Struct-of-arrays state for every REGISTERED client.

    All per-client state is packed (N,)/(N, 2) numpy arrays — no python
    object per client — so 10**6 registrations cost a few MB and every
    per-round operation is a vector op.  The scheduler owns the per-client
    wireless state (energy budgets, stale-bank age, channel/device scale
    draws); this class owns what the scheduler does not: geometry, the
    client -> ES map, data-skew sizes, cohort sampling, and the
    personalized-head bookkeeping.

    ``assignment="round_robin"`` (default) reproduces the historical
    ``HierarchyConfig`` layout via :func:`repro_torch.core.hierarchy.
    es_assignment` — the single source of truth, regression-pinned;
    ``"kmeans"`` clusters the client coordinates into ``num_es``
    location cells (paper Sec. II's ES coverage areas).
    """

    SAMPLING = ("uniform", "rate", "pareto")

    def __init__(self, num_clients: int, *, num_es: int = 1, seed: int = 0,
                 assignment: str = "round_robin", data_sigma: float = 0.0,
                 kmeans_iters: int = 25):
        if assignment not in ("round_robin", "kmeans"):
            raise ValueError(f"unknown ES assignment {assignment!r}")
        N = int(num_clients)
        if N < int(num_es):
            raise ValueError(f"{N} clients cannot cover {num_es} ESs")
        self.N = N
        self.num_es = int(num_es)
        self.assignment = assignment
        # the dedicated population stream: seed+5 (see module docstring)
        self._rng = np.random.default_rng(seed + 5)
        # client geometry: unit-square placements the k-means cells cluster
        self.coords = self._rng.random((N, 2))
        # data-skew stats: lognormal dataset sizes (sigma=0 -> uniform),
        # the alpha_u weights of whatever cohort trains this round
        if data_sigma > 0:
            self.data_size = self._rng.lognormal(mean=0.0, sigma=data_sigma,
                                                 size=N)
        else:
            self.data_size = np.ones(N)
        if assignment == "kmeans":
            self.es_assign, self.es_centers = kmeans_assign(
                self.coords, self.num_es, self._rng, iters=kmeans_iters)
        else:
            from repro_torch.core.hierarchy import es_assignment
            per_es = -(-N // self.num_es)            # ceil: labels < num_es
            self.es_assign = es_assignment(N, per_es)
            self.es_centers = None
        # per-ES member lists (index arrays) for balanced cohort draws
        self._by_es = [np.flatnonzero(self.es_assign == b)
                       for b in range(self.num_es)]
        # personalized-head pointer: the edge round whose head this client
        # last trained/refreshed (-1 = never participated; FedSim advances
        # it for each round's alive cohort members)
        self.head_slot = np.full(N, -1, dtype=np.int64)
        # participation counter (drives the pareto-style cap)
        self.part_count = np.zeros(N, dtype=np.int64)
        # per-client rate scale, bound by the CohortScheduler from its
        # channel (drives the "rate"-biased sampling); ones until bound
        self.rate_scale = np.ones(N)

    # ------------------------------------------------------- sampling -----
    def _draw(self, pool: np.ndarray, k: int, method: str) -> np.ndarray:
        """k clients from ``pool`` under one sampling rule (no count
        update; ``sample_cohort`` owns the bookkeeping)."""
        if k >= len(pool):
            return pool.copy()
        if method == "uniform":
            idx = self._rng.choice(len(pool), size=k, replace=False)
        elif method == "rate":
            # biased-by-rate: fast-channel clients proportionally likelier
            # (Pareto-optimality-style throughput bias)
            w = np.asarray(self.rate_scale, float)[pool]
            idx = self._rng.choice(len(pool), size=k, replace=False,
                                   p=w / w.sum())
        else:                                        # "pareto"
            # participation cap: the least-served clients first, random
            # tie-break, so lifetime participation stays near-uniform
            # however skewed the gates are
            jitter = self._rng.random(len(pool))
            order = np.lexsort((jitter, self.part_count[pool]))
            idx = order[:k]
        return pool[idx]

    def sample_cohort(self, size: int, method: str = "uniform", *,
                      es_balanced: bool = False) -> np.ndarray:
        """Draw one round's cohort (client ids) and count participation.

        ``es_balanced=True`` draws ``size / num_es`` clients from EACH
        ES's member pool, concatenated in ES order — the layout FedSim's
        (B, Ub) slot hierarchy needs (slot ``i`` belongs to ES
        ``i // Ub``).  Unbalanced draws sample the whole registry.
        """
        if method not in self.SAMPLING:
            raise ValueError(f"unknown sampling method {method!r}; one of "
                             f"{self.SAMPLING}")
        size = int(size)
        if es_balanced:
            if size % self.num_es:
                raise ValueError(f"es_balanced cohort size {size} is not a "
                                 f"multiple of num_es={self.num_es}")
            per = size // self.num_es
            short = [b for b, pool in enumerate(self._by_es)
                     if len(pool) < per]
            if short:
                raise ValueError(f"ESs {short} have fewer than {per} "
                                 f"registered clients")
            ids = np.concatenate([self._draw(pool, per, method)
                                  for pool in self._by_es])
        else:
            ids = self._draw(np.arange(self.N), min(size, self.N), method)
        self.part_count[ids] += 1
        return ids

    def cohort_mask(self, ids: np.ndarray) -> np.ndarray:
        """(N,) bool mask of a cohort id array."""
        mask = np.zeros(self.N, bool)
        mask[np.asarray(ids, int)] = True
        return mask


# ---------------------------------------------------------------------------
class CohortScheduler(ParticipationScheduler):
    """Population-scale scheduler: the oracle's decisions, vectorized.

    A strict subclass — construction, mutable state (energy budgets, stale
    bank, every RNG stream), checkpointing, and the fault-plan code path
    are inherited verbatim.  Only ``step()`` is rerouted: fault-free and
    ES-outage-only rounds run the two device stages of
    :mod:`repro_torch.wireless.scheduler_core` on ``core_device``
    (bit-identical to the oracle — the class docstring contract in
    ``scheduler.py``); rounds that draw an erasure/crash
    :class:`~repro_torch.wireless.faults.FaultPlan` fall back to
    ``super().step()`` on the same shared state.  ``core_device`` is a
    torch device (``None``: the card); ``device`` stays the oracle's
    compute :class:`~repro_torch.wireless.device.DeviceModel`.

    With a :class:`Population` attached, every ``step()`` restricts gate 1
    to a freshly sampled cohort (``sampling`` rule, ``cohort_size``
    clients) while the WHOLE registry's state advances — exactly the
    oracle's ``cohort_mask`` semantics.  ``sample_cohort()`` may be called
    ahead of ``step()`` (FedSim does, to know which clients to train);
    otherwise ``step()`` samples on entry.

    ``last_timeline`` is populated only when telemetry is enabled: the
    explicit per-client event timeline is O(N x chunks) host memory, which
    is precisely the cost this class exists to avoid.
    """

    def __init__(self, cfg: WirelessConfig, channel, bits=None, *,
                 cutter=None, es_assign=None, device=None, flops: float = 0.0,
                 telemetry=None, population: Population | None = None,
                 cohort_size: int | None = None, sampling: str = "uniform",
                 es_balanced: bool = False, core_device=None):
        super().__init__(cfg, channel, bits, cutter=cutter,
                         es_assign=es_assign, device=device, flops=flops,
                         telemetry=telemetry)
        if population is not None:
            if population.N != self.U:
                raise ValueError(f"population has {population.N} clients "
                                 f"but the channel was built for {self.U}")
            if cohort_size is None:
                raise ValueError("population runs need cohort_size")
            if sampling not in Population.SAMPLING:
                raise ValueError(f"unknown sampling method {sampling!r}")
            # bind the channel's heterogeneity scale as the rate bias
            population.rate_scale = self.channel._scale
        self.population = population
        self.cohort_size = cohort_size
        self.sampling = sampling
        self.es_balanced = es_balanced
        self._cohort = None          # pinned for the NEXT step() only
        self.last_cohort = None      # the cohort the LAST step() ran under
        # the spec and the device-resident constants of the core
        self.core_device = resolve_device(core_device)
        dev = self.core_device
        self._spec = core.build_spec(cfg, cutter=cutter, bits=bits,
                                     es_assign=self.es_assign,
                                     num_clients=self.U)
        if cutter is not None:
            self._tables = core.cell_tables(cutter, dev)
            self._fixed = None
        else:
            self._tables = None
            self._fixed = core.fixed_tables(bits, flops, self.U, dev)
        self._scale_d = self._f64(self.channel._scale)
        self._spf_d = self._f64(self.device.sec_per_flop)
        self._es_d = torch.as_tensor(self.es_assign, dtype=torch.int64,
                                     device=dev)

    def _f64(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.float64), dtype=core.F64,
                               device=self.core_device)

    # ------------------------------------------------------- cohorts ------
    def sample_cohort(self) -> np.ndarray:
        """Draw the NEXT round's cohort now (population mode only) and pin
        its mask; ``step()`` consumes the pin instead of resampling."""
        if self.population is None:
            raise ValueError("no population attached")
        ids = self.population.sample_cohort(self.cohort_size, self.sampling,
                                            es_balanced=self.es_balanced)
        self.cohort_mask = self.population.cohort_mask(ids)
        self._cohort = ids
        return ids

    # ---------------------------------------------------------- stepping --
    def step(self, round_idx: int) -> RoundReport:
        if self.population is not None and self._cohort is None:
            self.sample_cohort()
        self.last_cohort, self._cohort = self._cohort, None
        if self.injector is not None and self.injector.needs_plan:
            # erasure/crash rounds: data-dependent HARQ attempt shapes —
            # the inherited oracle path runs on the same shared state
            return super().step(round_idx)
        return self._step_core(round_idx)

    def _step_core(self, round_idx: int) -> RoundReport:
        cfg, U = self.cfg, self.U
        dev = self.core_device
        # ---- outage state (the only fault machinery without a plan;
        # round_plan() draws nothing when needs_plan is False, so the
        # fault stream stays in lockstep with the oracle's)
        self._plan = None
        self._es_eff = self.es_assign
        es_eff_d = self._es_d
        es_down = None
        client_down = None
        if self.injector is not None:
            es_down = self.injector.es_down(round_idx)
            if es_down is not None and es_down.any():
                self._es_eff, client_down = self.injector.failover(
                    es_down, self.es_assign)
                es_eff_d = torch.as_tensor(self._es_eff, dtype=torch.int64,
                                           device=dev)
            else:
                es_down = None

        # ---- host entropy: the channel's per-round draw (same stream,
        # same consumption as the oracle's sample()), copied in
        fade, down_row = self.channel.fades(round_idx)
        fade_d = self._f64(np.ones(U) if fade is None else fade)
        down_d = (None if down_row is None else self._f64(down_row))
        cd = np.zeros(U, bool) if client_down is None else client_down
        cd_d = torch.as_tensor(cd, device=dev)
        energy_d = self._f64(self.energy_left)

        spec = self._spec
        up, down, latency, cuts0, _, times0_d, _, gate1_d = \
            core.cohort_stage_a(spec, self._tables, self._fixed, fade_d,
                                down_d, self._scale_d, self._spf_d,
                                energy_d, cd_d)
        # ---- selection gate (host: np.argsort's quicksort tie order and
        # the thinning stream are host semantics, on bit-identical times0)
        times0 = times0_d.cpu().numpy()
        gate1 = gate1_d.cpu().numpy()
        if self.cohort_mask is not None:
            gate1 = gate1 & self.cohort_mask
        scheduled = gate1.copy()
        if cfg.selection == "topk" and cfg.topk > 0:
            order = np.argsort(np.where(scheduled, times0, np.inf))
            keep = np.zeros(U, bool)
            keep[order[:cfg.topk]] = True
            scheduled &= keep
        elif cfg.selection == "random" and cfg.participation_prob < 1.0:
            scheduled &= self._rng.random(U) < cfg.participation_prob

        def stage_b(sched_in):
            return core.cohort_stage_b(
                spec, self._tables, self._fixed,
                torch.as_tensor(sched_in, device=dev), up, down, latency,
                cuts0, energy_d, self._spf_d, es_eff_d)

        out = stage_b(scheduled)
        sched = out[4].cpu().numpy()
        n_backfilled = 0
        if (spec.contend and cfg.selection == "topk" and cfg.topk > 0
                and int(sched.sum()) < cfg.topk):
            # topk backfill (single pass): promote the next-fastest
            # never-withdrawn clients and re-run the pure contention
            # stage from the ORIGINAL private-rate cuts
            withdrawn = out[5].cpu().numpy()
            pool = gate1 & ~sched & ~withdrawn
            if pool.any():
                order = np.argsort(np.where(pool, times0, np.inf))
                extra = np.zeros(U, bool)
                extra[order[:cfg.topk - int(sched.sum())]] = True
                extra &= pool
                if extra.any():
                    out = stage_b(sched | extra)
                    sched = out[4].cpu().numpy()
                    n_backfilled = int((sched & extra).sum())
        (eff, cuts, comp_s, times, _, withdrawn, alive, energy_after,
         moved_up, moved_down, compute_j, tx_s, _) = (o.cpu().numpy()
                                                      for o in out)

        self.energy_left = energy_after
        if not alive.any():
            round_time = (float(cfg.deadline_s)
                          if sched.any() and np.isfinite(cfg.deadline_s)
                          else 0.0)
        elif (sched & ~alive).any():
            round_time = float(cfg.deadline_s)
        else:
            t = times[alive].max()
            round_time = float(t) if np.isfinite(t) else 0.0

        rep_cuts = rep_codecs = None
        if self.cutter is not None:
            rep_cuts = self.cutter.cut_pos[cuts]
            if self.cutter.has_codec_grid:
                rep_codecs = self.cutter.codec_pos[cuts]
            up_bits = np.asarray(self.cutter.up_bits, float)[cuts]
        else:
            up_bits = np.broadcast_to(
                np.asarray(self.bits.uplink, float), (U,))
        # the report's totals are numpy sums over host arrays (pairwise
        # summation), as the oracle takes them
        moved = moved_up + moved_down
        bits_tx = float(moved[sched].sum())

        stale_banked = stale_delivered = stale_dropped = None
        if cfg.staleness_lambda > 0.0:
            private = LinkState(up.cpu().numpy(), down.cpu().numpy(),
                                latency.cpu().numpy())
            stale_banked, stale_delivered, stale_dropped, bg_bits = \
                self._stale_update(
                    private, sched, alive, up_bits, moved_up, round_time,
                    push_ok=(None if es_down is None
                             else ~es_down[self._es_eff]),
                    bankable=None)
            bits_tx += bg_bits

        es_map = (self._es_eff.copy()
                  if es_down is not None
                  and not np.array_equal(self._es_eff, self.es_assign)
                  else None)
        rep = RoundReport(round_idx=round_idx, mask=alive.astype(np.float64),
                          times_s=times, round_time_s=round_time,
                          energy_left_j=self.energy_left.copy(),
                          scheduled=sched.copy(), cuts=rep_cuts,
                          uplink_bps=eff.copy(), codecs=rep_codecs,
                          bits_tx=bits_tx,
                          compute_s=comp_s.copy(), compute_j=compute_j,
                          stale_banked=stale_banked,
                          stale_delivered=stale_delivered,
                          stale_dropped=stale_dropped,
                          es_down=None if es_down is None
                          else es_down.copy(),
                          es_map=es_map)
        self.last_timeline = None
        tel = self.telemetry
        if tel is not None and getattr(tel, "enabled", False):
            # observability opts back into the explicit event timeline
            # (O(N x chunks) host arrays — the price of a full trace)
            from repro_torch.wireless.timeline import build_timeline
            bits = (self.cutter.bits_for(cuts) if self.cutter is not None
                    else self.bits)
            tl = build_timeline(
                LinkState(eff, down.cpu().numpy(), latency.cpu().numpy()),
                bits, comp_s, cfg.deadline_s, U, pipeline=cfg.pipeline)
            self.last_timeline = tl
            has_bank = self._stale_age >= 0
            tel.record_round(
                rep, tl, es_assign=self._es_eff,
                deadline_s=float(cfg.deadline_s),
                withdrawn=int(withdrawn.sum()),
                backfilled=n_backfilled,
                tx_j=float(cfg.tx_power_w * tx_s[sched].sum()),
                bank_depth=int(has_bank.sum()),
                bank_age_max=(int(self._stale_age[has_bank].max())
                              if has_bank.any() else 0))
        return rep

    # ------------------------------------------------------ checkpointing --
    def state_dict(self) -> dict:
        out = super().state_dict()
        if self.population is not None:
            from repro_torch.checkpoint.rng import rng_state_array
            out["population_rng"] = rng_state_array(self.population._rng)
            out["population_part"] = self.population.part_count.copy()
            out["population_head"] = self.population.head_slot.copy()
        return out

    def load_state_dict(self, state: dict) -> None:
        super().load_state_dict(state)
        if self.population is not None:
            from repro_torch.checkpoint.rng import restore_rng_state
            restore_rng_state(self.population._rng, state["population_rng"])
            self.population.part_count = np.asarray(
                state["population_part"], np.int64).copy()
            self.population.head_slot = np.asarray(
                state["population_head"], np.int64).copy()


# ------------------------------------------------------------- slot view --
def cohort_report(rep: RoundReport, cohort: np.ndarray) -> RoundReport:
    """Slice a population-wide (N,) :class:`RoundReport` down to the
    cohort's training SLOTS.

    FedSim trains ``len(cohort)`` stacked replicas ("slots"); the
    scheduler reports over the whole registry.  Slot ``i`` is population
    client ``cohort[i]``, so every per-client array is gathered by
    ``cohort`` — scalars (round time, bits moved) and the (B,) ES-outage
    mask pass through untouched.  Clients outside the cohort are never
    scheduled (gate 1 is masked), so no information is lost."""
    import dataclasses
    n = len(rep.mask)
    out = {}
    for f in dataclasses.fields(RoundReport):
        v = getattr(rep, f.name)
        if (f.name != "es_down" and isinstance(v, np.ndarray)
                and v.shape[:1] == (n,)):
            v = v[cohort]
        out[f.name] = v
    return RoundReport(**out)


# ---------------------------------------------------------------- factory --
def make_cohort_scheduler(cfg, num_clients: int, comm=None, kappa0: int = 1,
                          *, comm_table=None, es_assign=None, fixed_cut=0,
                          telemetry=None, population: Population | None = None,
                          cohort_size: int | None = None,
                          sampling: str = "uniform",
                          es_balanced: bool = False,
                          core_device=None) -> CohortScheduler:
    """``repro_torch.wireless.make_scheduler``'s population-scale twin.

    Identical byte accounting and construction, but the scheduler is a
    :class:`CohortScheduler` on ``core_device`` (optionally bound to a
    :class:`Population` whose ``es_assign`` should then be passed as
    ``es_assign``)."""
    from repro_torch.wireless import make_scheduler
    if population is not None:
        if population.N != int(num_clients):
            raise ValueError(f"population has {population.N} clients but "
                             f"num_clients={num_clients}")
        if es_assign is None:
            es_assign = population.es_assign
    return make_scheduler(cfg, num_clients, comm, kappa0,
                          comm_table=comm_table, es_assign=es_assign,
                          fixed_cut=fixed_cut, telemetry=telemetry,
                          cls=CohortScheduler, population=population,
                          cohort_size=cohort_size, sampling=sampling,
                          es_balanced=es_balanced, core_device=core_device)
