"""Wireless channel + client-participation subsystem.

The PyTorch port of ``repro.wireless``: the numpy oracle (channel,
cutter, device, faults, timeline, scheduler) is the reference's, re-homed,
with its telemetry hooks (``repro_torch.telemetry``); the
population-scale decision core (``scheduler_core``, ``population``) is
float64 torch tensor code on a device.

Turns the ideal-network PHSFL simulator into a network-aware one: every
client gets a per-edge-round uplink/downlink rate, latency, and energy
budget; a scheduler drops stragglers against a deadline and emits a 0/1
participation mask that the aggregation paths (``repro_torch.core.fedsim``,
``repro_torch.core.phsfl``) consume by renormalizing the Eq. 14-16 weights over
the participating clients only.  A per-round cut-layer controller
(``repro_torch.wireless.cutter``) exploits the paper's Remark 2 — the cut choice
never changes learning dynamics, only who pays which bits (Remark 1) — to
adapt the split point to channel state, ASFL-style.

``WirelessConfig`` knobs (``repro_torch.configs.base``)
=================================================

Channel (``repro_torch.wireless.channel.ChannelModel``):

- ``model``: rate process — ``"ideal"`` (infinite rate, zero latency: the
  pre-wireless simulator, and the default), ``"static"`` (constant rates),
  ``"rayleigh"`` (per-round exponential fading of the received power, i.e.
  Rayleigh amplitude), ``"trace"`` (replay ``trace`` rows).
- ``mean_uplink_mbps`` / ``mean_downlink_mbps``: mean per-client rates.
- ``latency_s``: per-message latency, charged once per direction per round.
- ``heterogeneity``: sigma of a lognormal per-client rate scale drawn once
  at construction — 0 means all clients statistically identical.
- ``trace``: round-major tuple of per-client uplink-Mbps tuples (cycled
  over rounds, resized over clients).
- ``trace_down``: optional round-major downlink trace (same shape rules);
  without one the downlink FALLS BACK to the uplink trace rescaled by the
  configured downlink/uplink mean ratio (fabricated, perfectly-correlated
  fading — record a real pair whenever asymmetry matters).
- ``es_uplink_mbps``: SHARED uplink capacity of each edge server.  The
  scheduled clients of one ES split it — each gets the smaller of its
  private rate and its share, so the per-ES aggregate rate never exceeds
  the capacity.  ``inf`` (default) keeps every uplink private; an ideal
  channel bypasses contention entirely.
- ``contention``: the sharing rule — ``"equal"`` (default) splits the pipe
  evenly among that round's scheduled clients; ``"proportional"`` weights
  shares by each client's private rate (proportional-fair scheduling).
- ``reshare_uplink``: after the contended price forces some clients to
  withdraw, a second contention pass (default True) re-shares the freed
  capacity among the survivors — their rates only rise, so one pass
  suffices; False reproduces the original conservative single pass.

Cut selection (``repro_torch.wireless.cutter.CutController``):

- ``cut_policy``: ``"fixed"`` (one declared cut — the pre-cutter behavior),
  ``"greedy"`` (per client, the cut minimizing estimated round time subject
  to the energy budget), ``"deadline"`` (the deepest affordable cut that
  still makes ``deadline_s`` at the contended rate).
- ``cut_candidates``: the candidate cuts, shallow to deep — CNN cut names
  (``repro_torch.models.cnn.CUT_CANDIDATES``) or LM client depths; ``()`` means
  the model's single default cut.  ``repro_torch.core.comm`` builds the per-cut
  ``(Z_0, Z_c)`` byte table (``comm_table_for_cnn``/``comm_table_for_lm``)
  the controller prices cuts with.  A table built with a dict of named
  ``repro_torch.compress.LinkCodecs`` prices the joint (cut, codec) GRID instead:
  the controller searches the flat cell list under the same policies and
  ``RoundReport.codecs`` carries each client's chosen codec.

Device / compute (``repro_torch.wireless.device.DeviceModel``):

- ``compute_gflops``: per-client compute rate in GFLOP/s.  The device model
  converts each round's client-side workload — ``client_round_flops``:
  kappa0 local epochs of client-block forward+backward at the chosen cut
  (per-cut conv/dense counts from ``repro_torch.utils.flops`` via
  ``CommModel.client_flops_per_sample``) plus codec encode/decode work —
  into per-round compute TIME (added to the round time the deadline gates
  on) and ENERGY (added to the transmit joules the budget gates on).
  ``inf`` (default) zeroes every compute term: the bits-only simulator,
  bit-for-bit.
- ``compute_heterogeneity``: lognormal sigma of a FIXED per-client compute
  scale (the compute twin of ``heterogeneity``; drawn once from an RNG
  stream disjoint from the channel's, so enabling it never perturbs fading).
- ``compute_power_w``: power drawn while computing; a scheduled client is
  charged ``compute_power_w * compute_s + tx_power_w * tx_s``, both capped
  at the deadline (see the scheduler docstring's straggler semantics).
- ``codec_cycles_per_element``: FLOPs per element crossing a LOSSY codec on
  the client (activations encoded up and gradients decoded down each
  minibatch, the client block encoded/decoded at the offload boundary) —
  the codec-aware energy model; 0 keeps codecs compute-free.

With finite compute the cut controller prices every (cut, codec) cell's
FLOPs next to its bits, so ``greedy``/``deadline`` see the full ASFL
trade-off: a deep cut ships fewer activation bits but burns more client
FLOPs, and a compute-starved client is steered to a shallower cut than its
fast-channel peer (``examples/device_aware_cut.py``,
``benchmarks/device_sweep.py``).

Pipelined streaming (``repro_torch.wireless.timeline``):

- ``pipeline``: overlap client compute with uplink streaming at minibatch
  granularity (Accelerating SFL-style).  Each of the round's ``kappa0 x
  batches_per_epoch`` minibatch activation payloads transmits as soon as
  its minibatch's compute finishes and the radio is free, so the uplink
  finishes at ``c + u + (n-1)*max(c, u) + tail`` instead of the serial
  ``n*c + n*u + tail`` — round time moves from compute + tx toward
  max(compute, tx) plus one fill bubble, saving exactly ``(n-1)*min(c, u)``
  per client (never worse, equal when compute is free or n == 1).  The
  deadline/energy gates, the charge, the moved-bits ledger, and the cut
  controller's estimates all price the overlapped timeline.  False
  (default) is the serial Eq.-17 model, bit-for-bit.

Staleness-weighted async edge aggregation (scheduler + ``core.fedsim``):

- ``staleness_lambda``: lambda in [0, 1].  When > 0, a deadline-cut
  straggler's undelivered uplink remainder is BANKED; on later rounds in
  which the client is idle its radio background-pushes the remainder at
  its private rate inside the round's wall-clock window (energy-charged
  like any transmission), and when the remainder lands the banked update
  is folded into THAT round's edge aggregation with weight
  ``alpha_u * lambda**staleness`` (staleness = edge rounds late, >= 1).
  A bank dies unfolded when a fresh completed round supersedes it or a
  newer straggle replaces it.  0 (default) disables the machinery and
  reproduces hard dropout bit-for-bit.  The aggregation fold lives in the
  CNN simulator (``FedSim``); the LM launcher prices the scheduler side
  only.

Fault injection + recovery (``repro_torch.wireless.faults``; all knobs live on
``WirelessConfig.faults``, a ``FaultConfig`` whose all-defaults instance is
the exact fault-free scheduler, bit-for-bit — the ``fault-free-default``
regression pins this):

- ``erasure_prob``: per-ATTEMPT probability that an uplink payload or the
  downlink broadcast is erased.  Erased transmissions retransmit (HARQ) up
  to ``max_retries`` times, each retry waiting ``backoff_s`` of radio idle
  first; the retransmitted copies are real timeline segments, priced by
  the same deadline gate / energy charge / moved-bits ledger as first
  transmissions, and ``RoundReport.retx_bits``/``retx_j`` isolate the
  overhead.  Graceful here means: a payload that exhausts its retries is
  REPORTED failed (``RoundReport.failed``) and — with ``staleness_lambda``
  > 0 — its undelivered remainder flows into the stale bank to land late
  and discounted, never silently lost.  The cut controller prices the
  expected HARQ expansion (``expected_attempts`` airtime multiplier) so
  adaptive cuts stay honest under lossy channels.
- ``es_outage_trace``: round-major 0/1 rows (cycled over rounds, resized
  over ESs) marking edge servers DOWN for whole rounds.  ``failover``
  picks the recovery: ``"reassoc"`` (default) re-associates a dead ES's
  clients to the nearest live ES — they re-enter ITS contention pass and
  join its aggregation — while ``"skip"`` sits them out (cost nothing).
  Graceful here means: the dead ES's edge model is carried forward
  unchanged (FedSim's zero-participant path) and banked stale pushes
  pause while their target ES is down.
- ``crash_hazard``: per-round probability a scheduled client dies at a
  uniform instant mid-round.  Its timeline freezes at the crash cap —
  partial compute charged, partial uplink credited as moved bits, the
  straggler freeze rule at the crash instant — and its local state is
  lost, so nothing is banked.  Graceful here means: the crash costs
  exactly what was spent, the ES never waits past the silence, and the
  report says who died (``RoundReport.crashed``).
- All fault draws come from a dedicated ``seed+4`` stream with fixed
  per-round shapes: enabling faults never perturbs fading/thinning/device
  draws, and checkpoint/resume replays the exact fault schedule.

Participation (``repro_torch.wireless.scheduler.ParticipationScheduler``):

- ``deadline_s``: edge-round deadline; a scheduled client whose simulated
  round time (2*latency + uplink airtime + downlink airtime for the
  Remark-1 traffic of ``client_round_bits`` at its chosen cut) exceeds it
  is dropped from that aggregation, and the ES waits the deadline out.
- ``selection``: ``"deadline"`` (energy+deadline gates only), ``"topk"``
  (schedule only the ``topk`` fastest affordable clients), ``"random"``
  (thin schedulable clients i.i.d. with ``participation_prob``).
- ``energy_budget_j`` / ``tx_power_w``: lifetime uplink energy budget and
  transmit power; budgets never recharge, and a client skips any round it
  cannot afford (under fading it may re-join a later, cheaper round).
  Every client that TRANSMITS pays for its airtime — a deadline-missing
  straggler is charged up to the deadline even though its update is
  discarded.
- ``seed``: RNG seed for fading draws, heterogeneity, and thinning.

Population & cohorts (``repro_torch.wireless.population``):

- ``Population(num_clients, num_es=, assignment=, seed=)``: the
  struct-of-arrays registry for population-scale runs — packed per-client
  coordinates, ES assignment (``"round_robin"`` via
  ``repro_torch.core.hierarchy.es_assignment`` or ``"kmeans"`` location
  clusters), Dirichlet data-skew sizes, a personalized-head round pointer,
  and a participation counter, sized for 10**5..10**6 registered clients.
  All population draws come from a dedicated ``seed + 5`` stream (channel
  = ``seed``, thinning ``+1``, device ``+2``, personalize ``+3``, faults
  ``+4``), so registering a population never perturbs the other streams.
- ``sampling``: per-round cohort selection over the registry —
  ``"uniform"`` (i.i.d.), ``"rate"`` (mean-uplink-biased), ``"pareto"``
  (participation-capped: the least-served eligible clients first, so
  coverage is Pareto-balanced across rounds); ``es_balanced=True`` keeps
  each ES's slot count fixed so the hierarchy shape never changes.
- ``CohortScheduler`` / ``make_cohort_scheduler``: a drop-in
  :class:`ParticipationScheduler` subclass whose fault-free and
  ES-outage-only rounds run as two float64 tensor stages over (N,)
  arrays on ``core_device`` (``repro_torch.wireless.scheduler_core``)
  instead of the host numpy loop — BIT-IDENTICAL to the oracle (pinned
  across every channel/contention/pipeline/fault config by
  ``tests/test_torch_cohort.py`` at U=8, and by ``chip_smoke.py`` on the
  card at 10**5 clients).
  Rounds carrying an erasure/crash fault plan delegate to the inherited
  oracle ``step()`` verbatim, sharing all mutable state.
- ``FedSim(..., population=, sampling=)`` / ``launch/train.py
  --population N --cohort-size C --sampling``: train over a registered
  population by sampling an ES-balanced cohort of ``hcfg.num_clients``
  training slots each round; ``cohort_report`` slices the (N,)-shaped
  :class:`RoundReport` down to the cohort's slots.  Requires a non-ideal
  channel and ``staleness_lambda == 0`` (the stale bank keys by client
  identity, which cohort slots remap per round).

Observability (``repro_torch.telemetry``):

- ``make_scheduler(..., telemetry=)`` / ``ParticipationScheduler(...,
  telemetry=)`` / ``FedSim(..., telemetry=)`` accept a
  :class:`repro_torch.telemetry.Telemetry` handle.  When enabled, every
  ``step()`` exports the round's :class:`RoundTimeline` — compute chunks,
  uplink payloads with their individual HARQ retransmission attempts,
  downlink, crash instants, ES outage spans — as Chrome/Perfetto trace
  events (one track per client and per ES; open the file at
  https://ui.perfetto.dev), and updates a typed metrics registry
  (participation, withdrawals/backfills, goodput vs retransmit bits,
  stale-bank depth/age, per-phase energy) flushed as JSONL.
  ``launch/train.py --trace-dir OUT`` wires all of it plus a run manifest.
- The default (``telemetry=None``) is the OFF state and is bit-inert: the
  hooks read the report and timeline, never scheduler state, draw no RNG,
  and are skipped entirely — the golden-history test and the
  ``telemetry-off-default`` reprolint rule pin this.

Aggregation semantics under a partial mask: participating clients keep
their Eq. 4/6 weights, renormalized to sum to 1; an edge round with ZERO
participants keeps the previous edge model; with a full (all-ones) mask
every path is bit-identical to the ideal-network simulator.
"""

from repro_torch.wireless.channel import (ChannelModel, LinkState,
                                          RoundBits, client_round_bits,
                                          waterfill_shares)
from repro_torch.wireless.cutter import (CutController, CutSpec, cut_specs,
                                         make_cut_controller)
from repro_torch.wireless.device import DeviceModel, client_round_flops
from repro_torch.wireless.faults import (FaultConfig, FaultInjector,
                                         FaultPlan, expected_attempts)
from repro_torch.wireless.scheduler import ParticipationScheduler, RoundReport
from repro_torch.wireless.population import (CohortScheduler, Population,
                                             cohort_report, kmeans_assign,
                                             make_cohort_scheduler)
from repro_torch.wireless.timeline import RoundTimeline, build_timeline

__all__ = [
    "ChannelModel", "LinkState", "RoundBits", "client_round_bits",
    "waterfill_shares",
    "CutController", "CutSpec", "cut_specs", "make_cut_controller",
    "DeviceModel", "client_round_flops",
    "FaultConfig", "FaultInjector", "FaultPlan", "expected_attempts",
    "ParticipationScheduler", "RoundReport", "make_scheduler",
    "CohortScheduler", "Population", "cohort_report", "kmeans_assign",
    "make_cohort_scheduler",
    "RoundTimeline", "build_timeline",
]


def make_scheduler(cfg, num_clients: int, comm=None, kappa0: int = 1, *,
                   comm_table=None, es_assign=None, fixed_cut=0,
                   telemetry=None, cls=None, **extra):
    """Convenience: CommModel byte accounting -> channel -> scheduler.

    Pass either one ``comm`` (a single fixed cut, the original behavior) or
    a ``comm_table`` — an ORDERED shallow-to-deep dict of cut -> CommModel
    from ``comm_table_for_cnn``/``comm_table_for_lm`` — in which case a
    :class:`CutController` with policy ``cfg.cut_policy`` prices the cuts
    per round.  ``es_assign`` maps each client to its edge server for the
    shared-uplink contention (default: all clients on one ES).  A
    :class:`DeviceModel` built from the same config prices client compute
    alongside the bits (free when ``compute_gflops`` is inf).
    ``telemetry`` (a :class:`repro_torch.telemetry.Telemetry`, default
    off) makes the scheduler record every round's trace and metrics.
    ``cls`` swaps the scheduler class (``repro_torch.wireless.population.
    CohortScheduler`` uses it, forwarding its population knobs and
    ``core_device`` through ``extra``); the default is
    :class:`ParticipationScheduler`, byte-for-byte.
    """
    cls = ParticipationScheduler if cls is None else cls
    channel = ChannelModel(cfg, num_clients)
    device = DeviceModel(cfg, num_clients)
    # HARQ pricing for the cut controller: only a lossy channel changes the
    # estimates (ea == 1, backoff == 0 keeps them bit-identical)
    ea, backoff = 1.0, 0.0
    if cfg.faults.erasure_prob > 0.0:
        ea = expected_attempts(cfg.faults.erasure_prob,
                               cfg.faults.max_retries)
        backoff = cfg.faults.backoff_s
    if comm_table is not None:
        cutter = make_cut_controller(
            comm_table, kappa0, policy=cfg.cut_policy, fixed_cut=fixed_cut,
            deadline_s=cfg.deadline_s, tx_power_w=cfg.tx_power_w,
            compute_power_w=cfg.compute_power_w,
            codec_cycles_per_element=cfg.codec_cycles_per_element,
            pipeline=cfg.pipeline, expected_attempts=ea,
            harq_backoff_s=backoff)
        return cls(cfg, channel, cutter=cutter, es_assign=es_assign,
                   device=device, telemetry=telemetry, **extra)
    bits = client_round_bits(comm, kappa0)
    flops = client_round_flops(
        comm, kappa0, codec_cycles_per_element=cfg.codec_cycles_per_element)
    return cls(cfg, channel, bits, es_assign=es_assign, device=device,
               flops=flops, telemetry=telemetry, **extra)
