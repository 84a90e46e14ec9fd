"""The population-scale decision core, as float64 torch tensor code.

The PyTorch rendering of ``repro.wireless.scheduler_core``.  It
re-expresses the fault-free per-round decision path of
:class:`repro_torch.wireless.scheduler.ParticipationScheduler` — channel
rate construction, the :class:`~repro_torch.wireless.cutter.CutController`
(cut, codec) grid argmin, device compute times, the serial/pipelined
timeline aggregates, per-ES contention (equal and water-filled
proportional), the withdrawal + reshare pass, and the deadline/energy
gates with the moved-bits ledger — as tensor operations over the whole
client axis on one device (the card, or the CPU when asked), so one
round's scheduling for 10**5..10**6 registered clients is two stages of
device work (plus a small host step between them for the selection gate).
The numpy scheduler stays the ORACLE; this core's contract is bit-identity
to it, pinned by the U=8 property test (``tests/test_torch_cohort.py``)
and, on the card, at 10**5 clients (``chip_smoke.check_cohort``).

Bit-identity strategy
---------------------
* Everything is float64: every array input arrives as a float64, bool or
  int64 tensor, and python scalars promote to float64 as in numpy.
* One IEEE operation per step.  Each ``+ - * /`` is its own tensor
  operation, so nothing contracts ``a*b + c`` into a fused multiply-add
  or reassociates a sum: no ``addcmul``, ``lerp``, fused custom ops or
  ``torch.compile`` here.  With that, CUDA and the CPU give numpy's bits
  for ``+ - * /``, ``minimum``, ``maximum`` and ``where``; ``argmin``
  returns the first minimum and ``nan_to_num`` uses numpy's defaults.
* Reductions whose float association ORDER numpy fixes are replicated:
  the pipelined per-chunk overlap sum is :func:`_rowsum_np_order`
  (numpy's pairwise summation for a trailing axis, column by column), and
  the per-ES sums of the water-filling and of the equal split are
  :func:`segment_sum_np_order`: ``np.bincount(weights=...)`` adds each
  group's members in index order from 0.0, and ``index_add_`` /
  ``scatter_add_`` on CUDA add in whatever order their atomics land.
  The water-filling loop runs on the device one iteration at a time with
  the oracle's exact per-iteration expressions.
* Entropy stays HOST-side: fading draws, thinning draws, and fault plans
  come from the same numpy ``Generator`` streams the oracle uses and are
  copied in as tensors — the core is a pure function of them.
* Control flow the oracle makes data-dependent (the conditional reshare
  second pass) is computed unconditionally and selected with ``where`` on
  the device predicate; control flow that no device sort reproduces
  (``np.argsort``'s quicksort tie order for top-k) stays on the host
  between the two stages, operating on bit-identical inputs.

Fault-plan rounds (erasures/crashes) have data-dependent attempt-column
shapes and are delegated by :class:`repro_torch.wireless.population.
CohortScheduler` to the numpy oracle path; ES-outage-only rounds stay on
this core (the outage masks are host inputs).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

F64 = torch.float64

# Pipelined chunk sums replicate numpy's pairwise summation, whose simple
# closed forms cover n <= 128 columns; beyond that numpy recurses and the
# replication (and any sane chunk count) ends.
MAX_CHUNKS = 128


@dataclass(frozen=True)
class CoreSpec:
    """Static configuration of one cohort scheduling round.

    Every field mirrors the oracle knob it is named after.  ``contend`` is
    the oracle's contention-bypass predicate evaluated once (ideal channel
    or infinite ES capacity never contends)."""

    model: str               # "ideal" | "static" | "rayleigh" | "trace"
    up_mean_bps: float
    down_mean_bps: float
    latency_s: float
    has_down_trace: bool     # trace model with a measured downlink trace
    contend: bool
    contention: str          # "equal" | "proportional"
    es_cap_bps: float
    num_es: int
    reshare: bool
    has_cutter: bool
    adaptive: bool           # cutter present and policy != "fixed"
    policy: str              # "fixed" | "greedy" | "deadline"
    fixed_cut: int
    num_cells: int
    cutter_deadline_s: float
    cutter_tx_power_w: float
    cutter_compute_power_w: float
    cutter_pipeline: bool
    cutter_ea: float         # expected HARQ attempts priced by the cutter
    cutter_hb: float         # HARQ backoff seconds priced by the cutter
    deadline_s: float
    tx_power_w: float
    compute_power_w: float
    pipeline: bool
    chunks: int


# ------------------------------------------------------- exact primitives --
def _maximum(a: torch.Tensor, b) -> torch.Tensor:
    """``np.maximum`` with a tensor or a python scalar on either side."""
    if not isinstance(b, torch.Tensor):
        b = torch.tensor(b, dtype=a.dtype, device=a.device)
    return torch.maximum(a, b)


def _minimum(a: torch.Tensor, b) -> torch.Tensor:
    if not isinstance(b, torch.Tensor):
        b = torch.tensor(b, dtype=a.dtype, device=a.device)
    return torch.minimum(a, b)


def _clip(a: torch.Tensor, lo, hi) -> torch.Tensor:
    """``np.clip(a, lo, hi)`` = ``minimum(maximum(a, lo), hi)``."""
    return _minimum(_maximum(a, lo), hi)


def segment_sum_np_order(x: torch.Tensor, groups: torch.Tensor,
                         num_groups: int) -> torch.Tensor:
    """``np.bincount(groups, weights=x, minlength=num_groups)``, bit for bit.

    numpy adds each group's members one after another in index order,
    starting from 0.0.  Zeros are left out first (adding a zero to a sum
    that started at +0.0 never changes its bits, and the water-filling's
    inputs are zero outside the round's active clients).  A stable sort by
    group keeps every group's members in index order;
    ``torch.segment_reduce`` over the sorted (n, 1) column then sums each
    segment sequentially from 0.0 — on the CPU in one loop per segment, on
    CUDA in one thread per segment (the kernel it takes for data of more
    than one dimension; one-dimensional data would go to a tree-shaped
    segmented reduction instead).  Empty groups give 0.0."""
    nz = torch.nonzero(x).squeeze(1)                  # ascending indices
    xs, gs = x[nz], groups[nz]
    order = torch.argsort(gs, stable=True)
    lengths = torch.bincount(gs, minlength=num_groups)
    out = torch.segment_reduce(xs[order][:, None], "sum", lengths=lengths,
                               axis=0)
    return out[:, 0]


def _rowsum_np_order(cols):
    """Sum n (U,) columns in numpy's np.sum(axis=1) association order.

    numpy reduces a C-contiguous trailing axis with pairwise summation:
    a zero-seeded sequential loop for n < 8, and the 8-accumulator
    unrolled block (with a sequential remainder) for 8 <= n <= 128.
    Replicating the exact order keeps the pipelined timeline aggregates
    bitwise-identical to the oracle's ``.sum(axis=1)``.
    """
    n = len(cols)
    assert 1 <= n <= MAX_CHUNKS
    if n < 8:
        res = 0.0 + cols[0]
        for k in range(1, n):
            res = res + cols[k]
        return res
    r = list(cols[:8])
    i = 8
    while i + 8 <= n:
        for j in range(8):
            r[j] = r[j] + cols[i + j]
        i += 8
    res = ((r[0] + r[1]) + (r[2] + r[3])) + ((r[4] + r[5]) + (r[6] + r[7]))
    for k in range(i, n):
        res = res + cols[k]
    return res


# ---------------------------------------------------------------- rates --
def _rates(spec: CoreSpec, fade, down_row, scale):
    """ChannelModel.sample()'s rate expressions over host-drawn entropy.

    ``fade`` is the per-round fading array drawn host-side from the
    channel's own numpy stream (ones for static, Exp(1) for rayleigh, the
    resized trace row scaled by ``1e6 / up_mean`` for trace), so the rate
    VALUES equal the oracle's bit-for-bit."""
    if spec.model == "ideal":
        inf = torch.full(scale.shape, float("inf"), dtype=F64,
                         device=scale.device)
        return inf, inf, torch.zeros(scale.shape, dtype=F64,
                                     device=scale.device)
    up = _maximum(spec.up_mean_bps * scale * fade, 1.0)
    down = _maximum(spec.down_mean_bps * scale * fade, 1.0)
    if spec.has_down_trace:
        down = _maximum(down_row * 1e6 * scale, 1.0)
    return up, down, torch.full(scale.shape, spec.latency_s, dtype=F64,
                                device=scale.device)


# ------------------------------------------------------------ cut decide --
def _estimates(spec: CoreSpec, tables, up, down, latency, spf):
    """CutController._estimates over the (cells, U) grid, verbatim."""
    t_up = tables["up_bits"][:, None] / up[None, :]
    t_down = tables["down_bits"][:, None] / down[None, :]
    t_up = torch.nan_to_num(t_up, nan=0.0)
    t_down = torch.nan_to_num(t_down, nan=0.0)
    ea, hb = spec.cutter_ea, spec.cutter_hb
    t_up_air = t_up
    harq = ea != 1.0 or hb != 0.0
    if harq:
        gap = (ea - 1.0) * hb
        t_up_air = ea * t_up
        t_up = t_up_air + gap
        t_down = ea * t_down + gap
    t_comp = tables["flops"][:, None] * spf[None, :]
    if spec.cutter_pipeline:
        u = torch.nan_to_num(tables["up_stream"][:, None] / up[None, :],
                             nan=0.0)
        t_tail = torch.nan_to_num(tables["up_tail"][:, None] / up[None, :],
                                  nan=0.0)
        if harq:
            u = ea * u + gap
            t_tail = ea * t_tail + gap
        c = t_comp / spec.chunks
        up_finish = c + u + (spec.chunks - 1) * torch.maximum(c, u) + t_tail
        times = 2 * latency[None, :] + up_finish + t_down
    else:
        times = 2 * latency[None, :] + t_up + t_down
        times = times + t_comp
    energy = spec.cutter_tx_power_w * t_up_air
    energy = energy + spec.cutter_compute_power_w * t_comp
    return times, energy


def _decide(spec: CoreSpec, tables, up, down, latency, energy_left, spf):
    """CutController.decide() over the cohort (fixed/greedy/deadline)."""
    if not spec.has_cutter or spec.policy == "fixed" or spec.num_cells == 1:
        return torch.full(up.shape, spec.fixed_cut, dtype=torch.int64,
                          device=up.device)
    times, energy = _estimates(spec, tables, up, down, latency, spf)
    affordable = energy <= energy_left[None, :]
    t_aff = torch.where(affordable, times, float("inf"))
    fastest_aff = torch.argmin(t_aff, dim=0)
    cheapest = torch.argmin(energy, dim=0)
    none_affordable = ~affordable.any(dim=0)
    if spec.policy == "greedy":
        return torch.where(none_affordable, cheapest, fastest_aff)
    feasible = affordable & (times <= spec.cutter_deadline_s)
    idx = torch.arange(spec.num_cells, device=up.device)[:, None]
    deepest = torch.where(feasible, idx, -1).amax(dim=0)
    out = torch.where(deepest >= 0, deepest, fastest_aff)
    return torch.where(none_affordable, cheapest, out)


def _bits_comp(spec: CoreSpec, tables, fixed, cuts, spf):
    """Per-client bit arrays + compute times of a cut-index vector."""
    if spec.has_cutter:
        b_up = tables["up_bits"][cuts]
        b_down = tables["down_bits"][cuts]
        b_stream = tables["up_stream"][cuts]
        b_tail = tables["up_tail"][cuts]
        comp_s = tables["flops"][cuts] * spf
    else:
        b_up = fixed["up_bits"]
        b_down = fixed["down_bits"]
        b_stream = fixed["up_stream"]
        b_tail = fixed["up_tail"]
        comp_s = fixed["flops"] * spf
    return b_up, b_down, b_stream, b_tail, comp_s


# --------------------------------------------------------------- timeline --
def _timeline_agg(spec: CoreSpec, up, down, latency, b_up, b_down,
                  b_stream, b_tail, comp_s):
    """The serial/pipelined RoundTimeline AGGREGATES (times, charged
    compute/tx seconds, downlink window, can_tx) in the oracle builders'
    exact expression order (repro_torch.wireless.timeline._serial/
    _pipelined)."""
    deadline = spec.deadline_s
    if not spec.pipeline:
        t_up_clock = b_up / up
        t_down = b_down / down
        t_up = torch.where(torch.isfinite(t_up_clock), t_up_clock, 0.0)
        t_down_f = torch.where(torch.isfinite(t_down), t_down, 0.0)
        times = 2 * latency + t_up_clock + t_down + comp_s
        c_s = _minimum(comp_s, deadline)
        window = _maximum(deadline - comp_s, 0.0)
        tx_s = torch.minimum(t_up, window)
        down_start = comp_s + t_up
        down_win = _clip(deadline - down_start, 0.0, t_down_f)
        can_tx = window > 0
        return times, c_s, tx_s, down_win, can_tx
    n = spec.chunks
    u = b_stream / up
    t_tail = b_tail / up
    t_down = b_down / down
    u = torch.where(torch.isfinite(u), u, 0.0)
    t_tail = torch.where(torch.isfinite(t_tail), t_tail, 0.0)
    t_down = torch.where(torch.isfinite(t_down), t_down, 0.0)
    c = comp_s / n
    # per-chunk streaming columns, summed in numpy's association order
    ov_cols = []
    for i in range(n):
        tx_start_i = torch.maximum((i + 1) * c, c + i * u)
        ov_cols.append(_clip(deadline - tx_start_i, 0.0, u))
    tail_start = torch.maximum(n * c, c + (n - 1) * u) + u
    up_finish = tail_start + t_tail
    times = 2 * latency + up_finish + t_down
    c_s = _minimum(comp_s, deadline)
    tx_s = (_rowsum_np_order(ov_cols)
            + _clip(deadline - tail_start, 0.0, t_tail))
    down_win = _clip(deadline - up_finish, 0.0, t_down)
    can_tx = c < deadline
    return times, c_s, tx_s, down_win, can_tx


# -------------------------------------------------------------- contention --
def _waterfill(cap, w, limits, groups, active, num_groups):
    """channel.waterfill_shares on the device, expression-for-expression:
    one pass of the oracle's loop per iteration, until no member caps."""
    capped = torch.zeros(w.shape, dtype=torch.bool, device=w.device)
    while True:
        w_unc = torch.where(active & ~capped, w, 0.0)
        totals = segment_sum_np_order(w_unc, groups, num_groups)
        used = segment_sum_np_order(torch.where(active & capped, limits, 0.0),
                                    groups, num_groups)
        remaining = _maximum(cap - used, 0.0)
        share = remaining[groups] * w / _maximum(totals[groups], 1.0)
        newly = active & ~capped & (limits <= share)
        if not bool(newly.any()):
            break
        capped = capped | newly
    return torch.where(active & capped, limits, share)


def _contended_up(spec: CoreSpec, up, active, es):
    """ChannelModel.contended_uplink for a contended spec."""
    cap = spec.es_cap_bps
    if spec.contention == "proportional":
        share = _waterfill(cap, up, up, es, active, spec.num_es)
    else:
        counts = segment_sum_np_order(torch.where(active, 1.0, 0.0), es,
                                      spec.num_es)
        share = cap / _maximum(counts[es], 1.0)
    return torch.where(active, torch.minimum(up, share), up)


# ------------------------------------------------------------------ stages --
@torch.no_grad()
def cohort_stage_a(spec: CoreSpec, tables, fixed, fade, down_row, scale,
                   spf, energy_left, client_down):
    """Private-rate decision pass: rates, cut decide, timeline, gate 1.

    Returns (up, down, latency, cuts, comp_s, times0, charge0, gate1) —
    ``times0`` feeds the host's top-k argsort (whose quicksort tie order
    must be numpy's), ``gate1`` is the energy+window (+outage) gate."""
    up, down, latency = _rates(spec, fade, down_row, scale)
    cuts = _decide(spec, tables, up, down, latency, energy_left, spf)
    b_up, b_down, b_stream, b_tail, comp_s = _bits_comp(
        spec, tables, fixed, cuts, spf)
    times0, c_s, tx_s, _, can_tx = _timeline_agg(
        spec, up, down, latency, b_up, b_down, b_stream, b_tail, comp_s)
    charge0 = spec.tx_power_w * tx_s + spec.compute_power_w * c_s
    gate1 = (energy_left >= charge0) & can_tx & ~client_down
    return up, down, latency, cuts, comp_s, times0, charge0, gate1


@torch.no_grad()
def cohort_stage_b(spec: CoreSpec, tables, fixed, scheduled_in, up, down,
                   latency, cuts_in, energy_left, spf, es_assign):
    """Contention + final gates + ledger over a chosen scheduled set.

    Mirrors ParticipationScheduler._contend (adaptive re-decide at the
    contended rates, withdrawal, the conditional reshare second pass —
    computed unconditionally and selected on the device predicate) and
    the oracle's post-contention body: the deadline gate, the energy
    deduction, and the fault-free moved-bits ledger.  Pure: the top-k
    backfill calls it a second time on the refilled set with the same
    private inputs."""
    if spec.contend:
        eff1 = _contended_up(spec, up, scheduled_in, es_assign)
        if spec.adaptive:
            cuts2 = _decide(spec, tables, eff1, down, latency, energy_left,
                            spf)
            cuts = torch.where(scheduled_in, cuts2, cuts_in)
        else:
            cuts = cuts_in
        b_up, b_down, b_stream, b_tail, comp_s = _bits_comp(
            spec, tables, fixed, cuts, spf)
        _, c_s1, tx_s1, _, can1 = _timeline_agg(
            spec, eff1, down, latency, b_up, b_down, b_stream, b_tail,
            comp_s)
        charge1 = spec.tx_power_w * tx_s1 + spec.compute_power_w * c_s1
        ok = (energy_left >= charge1) & can1
        withdrawn = scheduled_in & ~ok
        sched = scheduled_in & ok
        if spec.reshare:
            do2 = withdrawn.any() & sched.any()
            eff2 = _contended_up(spec, up, sched, es_assign)
            eff = torch.where(do2, eff2, eff1)
        else:
            eff = eff1
    else:
        eff = up
        cuts = cuts_in
        b_up, b_down, b_stream, b_tail, comp_s = _bits_comp(
            spec, tables, fixed, cuts, spf)
        withdrawn = torch.zeros(up.shape, dtype=torch.bool, device=up.device)
        sched = scheduled_in
    times, c_s, tx_s, down_win, _ = _timeline_agg(
        spec, eff, down, latency, b_up, b_down, b_stream, b_tail, comp_s)
    charge = spec.tx_power_w * tx_s + spec.compute_power_w * c_s
    alive = sched & (times <= spec.deadline_s)
    energy_after = torch.where(sched, energy_left - charge, energy_left)
    # fault-free moved-bits ledger (oracle: full traffic when alive, else
    # rate x charged airtime / downlink window; the nan of inf*0 never
    # survives the where)
    moved_up = torch.where(alive, b_up, torch.where(tx_s > 0, eff * tx_s, 0.0))
    moved_down = torch.where(alive, b_down,
                        torch.where(down_win > 0, down * down_win, 0.0))
    compute_j = torch.where(sched, spec.compute_power_w * c_s, 0.0)
    return (eff, cuts, comp_s, times, sched, withdrawn, alive,
            energy_after, moved_up, moved_down, compute_j, tx_s, charge)


# ----------------------------------------------------------- spec builders --
def build_spec(cfg, *, cutter=None, bits=None, es_assign,
               num_clients) -> CoreSpec:
    """Derive the CoreSpec of a scheduler configuration.

    ``cutter``/``bits`` follow the ParticipationScheduler constructor
    (exactly one).  Raises for shapes the vectorized path cannot
    reproduce bit-identically (pipelined chunk counts beyond numpy's
    non-recursive pairwise-summation range)."""
    del num_clients  # shape comes from the arrays; kept for call clarity
    cap = cfg.es_uplink_mbps * 1e6
    contend = cfg.model != "ideal" and bool(np.isfinite(cap))
    es = np.asarray(es_assign, int)
    num_es = int(es.max()) + 1 if es.size else 1
    if cutter is not None:
        chunks = max(int(cutter.chunks), 1)
        spec_kw = dict(
            has_cutter=True, adaptive=cutter.policy != "fixed",
            policy=cutter.policy, fixed_cut=int(cutter.fixed_cut),
            num_cells=cutter.num_cuts,
            cutter_deadline_s=float(cutter.deadline_s),
            cutter_tx_power_w=float(cutter.tx_power_w),
            cutter_compute_power_w=float(cutter.compute_power_w),
            cutter_pipeline=bool(cutter.pipeline),
            cutter_ea=float(cutter.expected_attempts),
            cutter_hb=float(cutter.harq_backoff_s))
    else:
        chunks = max(int(bits.chunks), 1)
        spec_kw = dict(
            has_cutter=False, adaptive=False, policy="fixed", fixed_cut=0,
            num_cells=1, cutter_deadline_s=float("inf"),
            cutter_tx_power_w=0.0, cutter_compute_power_w=0.0,
            cutter_pipeline=False, cutter_ea=1.0, cutter_hb=0.0)
    if cfg.pipeline and chunks > MAX_CHUNKS:
        raise ValueError(
            f"pipelined chunk count {chunks} exceeds {MAX_CHUNKS}: numpy "
            f"sums that many columns with recursive pairwise blocks, which "
            f"the vectorized path does not replicate")
    return CoreSpec(
        model=cfg.model, up_mean_bps=cfg.mean_uplink_mbps * 1e6,
        down_mean_bps=cfg.mean_downlink_mbps * 1e6,
        latency_s=float(cfg.latency_s),
        has_down_trace=bool(cfg.model == "trace" and cfg.trace_down),
        contend=contend, contention=cfg.contention, es_cap_bps=float(cap),
        num_es=num_es, reshare=bool(cfg.reshare_uplink),
        deadline_s=float(cfg.deadline_s), tx_power_w=float(cfg.tx_power_w),
        compute_power_w=float(cfg.compute_power_w),
        pipeline=bool(cfg.pipeline), chunks=chunks, **spec_kw)


def _on(arrays: dict, device) -> dict:
    return {k: torch.as_tensor(v, dtype=F64, device=device)
            for k, v in arrays.items()}


def cell_tables(cutter, device) -> dict:
    """The cutter's per-cell arrays as the core's gather tables."""
    return _on({"up_bits": np.asarray(cutter.up_bits, np.float64),
                "down_bits": np.asarray(cutter.down_bits, np.float64),
                "up_stream": np.asarray(cutter.up_stream, np.float64),
                "up_tail": np.asarray(cutter.up_tail, np.float64),
                "flops": np.asarray(cutter.flops, np.float64)}, device)


def fixed_tables(bits, flops: float, num_clients: int, device) -> dict:
    """Fixed-bits mode: per-client (U,) bit arrays + the scalar workload.

    Mirrors the oracle's broadcasting of scalar RoundBits and the
    pipelined builder's ``up_stream is None`` degeneration (the whole
    uplink as one stream payload, no tail)."""
    def bc(x):
        return np.ascontiguousarray(
            np.broadcast_to(np.asarray(x, np.float64), (num_clients,)))
    stream = bits.up_stream if bits.up_stream is not None else bits.uplink
    tail = bits.up_tail if bits.up_stream is not None else 0.0
    return _on({"up_bits": bc(bits.uplink), "down_bits": bc(bits.downlink),
                "up_stream": bc(stream), "up_tail": bc(tail),
                "flops": np.asarray(flops, np.float64)}, device)
