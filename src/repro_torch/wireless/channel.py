"""Per-client wireless channel model (rates, latency, time, energy).

The channel turns the byte accounting of :mod:`repro_torch.core.comm` (Remark 1:
cut-layer activations up, cut-layer gradients down, client-block offloads at
the round boundary) into per-client, per-edge-round transmission TIMES and
ENERGIES.  Three rate processes are supported:

- ``static``:   rate_u(t) = mean * scale_u — a fixed, possibly heterogeneous
                rate per client (``heterogeneity`` is the lognormal sigma of
                scale_u, drawn once at construction);
- ``rayleigh``: rate_u(t) = mean * scale_u * E_t where E_t ~ Exp(1) i.i.d.
                per round — Rayleigh-amplitude fading makes the received
                POWER exponential, and we model the achievable rate as
                proportional to it (interference-limited linear regime);
- ``trace``:    rate_u(t) read from ``WirelessConfig.trace`` (round-major,
                cycled), for replaying measured traces.  The downlink comes
                from ``WirelessConfig.trace_down`` (same shape rules) when
                recorded; without one it FALLS BACK to the uplink trace
                rescaled by the configured mean downlink/uplink ratio;
- ``ideal``:    infinite rates, zero latency — the pre-wireless simulator.

All rates are in Mbps in the config and bits/s internally.

The port's copy of ``repro.wireless.channel``: numpy, as in the reference,
with its imports pointed at the port.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.configs.base import WirelessConfig
from repro_torch.core.comm import CommModel


@dataclass
class LinkState:
    """Per-client link quality for one edge round (all arrays shape (U,))."""
    uplink_bps: np.ndarray
    downlink_bps: np.ndarray
    latency_s: np.ndarray


@dataclass(frozen=True)
class RoundBits:
    """Bits each client moves in one edge round (split-learning dataflow).

    Scalar for a shared fixed cut, or per-client ``(U,)`` arrays when a
    :class:`repro_torch.wireless.cutter.CutController` picks per-client cuts.

    The optional STREAM decomposition carries the minibatch granularity the
    pipelined timeline needs: the uplink is ``chunks`` equal per-minibatch
    payloads of ``up_stream`` bits (activations + indices), each eligible to
    transmit as soon as its minibatch's compute finishes, plus one
    ``up_tail`` payload (the client-block offload Phi_off) that only ships
    after the last minibatch.  ``chunks * up_stream + up_tail == uplink``
    whenever the decomposition is present; legacy two-field construction
    (``up_stream=None``) degenerates to one monolithic chunk, under which
    the pipelined timeline equals the serial one exactly."""
    uplink: int | np.ndarray
    downlink: int | np.ndarray
    up_stream: int | np.ndarray | None = None   # bits per minibatch payload
    up_tail: int | np.ndarray = 0               # offload bits, after chunks
    chunks: int = 1                             # kappa0 * batches_per_epoch


def client_round_bits(comm: CommModel, kappa0: int) -> RoundBits:
    """Per-edge-round traffic of ONE client under the paper's Eq. 17 terms.

    Uplink:   kappa0 local epochs of (activations o_fp + minibatch indices)
              per minibatch, plus one client-block offload (Phi_off).
    Downlink: the matching cut-layer gradients o_bp, plus the refreshed
              client block broadcast at the aggregation boundary.

    Each payload travels through the CommModel's configured codec
    (repro_torch.compress) — with no codecs this is the original (omega+1)-bit
    accounting exactly.  The uplink's minibatch decomposition is recorded
    (``up_stream``/``up_tail``/``chunks``) so the pipelined timeline can
    stream each minibatch payload as soon as its compute finishes.
    """
    per_batch_up = comm.phi_activation_up_bits() + comm.phi_indices_bits()
    per_batch_down = comm.phi_grad_down_bits()
    nb = comm.batches_per_epoch
    return RoundBits(
        uplink=kappa0 * nb * per_batch_up + comm.phi_off_bits(),
        downlink=kappa0 * nb * per_batch_down + comm.phi_off_bits(),
        up_stream=per_batch_up, up_tail=comm.phi_off_bits(),
        chunks=kappa0 * nb,
    )


class ChannelModel:
    """Samples per-round link states and converts bits to time/energy."""

    def __init__(self, cfg: WirelessConfig, num_clients: int):
        if cfg.model not in ("ideal", "static", "rayleigh", "trace"):
            raise ValueError(f"unknown channel model {cfg.model!r}")
        if cfg.model == "trace" and not cfg.trace:
            raise ValueError("trace channel requires WirelessConfig.trace")
        if (cfg.model == "trace" and cfg.trace_down
                and len(cfg.trace_down) != len(cfg.trace)):
            # both traces cycle modulo their own length; unequal lengths
            # would silently desynchronize the measured (up, down) pairs
            raise ValueError(
                f"trace_down has {len(cfg.trace_down)} rounds but trace has "
                f"{len(cfg.trace)}; a measured pair must align round-for-"
                f"round (both cycle together)")
        if cfg.contention not in ("equal", "proportional"):
            raise ValueError(f"unknown contention rule {cfg.contention!r}; "
                             f"one of ('equal', 'proportional')")
        self.cfg = cfg
        self.U = num_clients
        self._rng = np.random.default_rng(cfg.seed)
        # fixed per-client heterogeneity scale (lognormal, mean-1 median)
        if cfg.heterogeneity > 0:
            self._scale = self._rng.lognormal(
                mean=0.0, sigma=cfg.heterogeneity, size=num_clients)
        else:
            self._scale = np.ones(num_clients)

    # ----------------------------------------------------------- sampling --
    def fades(self, round_idx: int):
        """This round's fading entropy: ``(fade, down_row)``.

        The ONLY per-round stochastic draw of the channel, factored out so
        the vectorized cohort path (``repro_torch.wireless.scheduler_core``) can
        consume the same stream and rebuild the same rates in-trace:
        ``fade`` is ones (static), Exp(1) draws (rayleigh), or the resized
        trace row rescaled to a fade factor; ``down_row`` is the resized
        measured downlink trace row (None without one).  ``sample`` is
        defined in terms of this method, so both paths advance ``_rng``
        identically.  Returns ``(None, None)`` for the ideal model."""
        cfg, U = self.cfg, self.U
        if cfg.model == "ideal":
            return None, None
        if cfg.model == "static":
            fade = np.ones(U)
        elif cfg.model == "rayleigh":
            fade = self._rng.exponential(1.0, size=U)
        else:  # trace
            row = np.asarray(cfg.trace[round_idx % len(cfg.trace)], float)
            up_mean = cfg.mean_uplink_mbps * 1e6
            fade = np.resize(row, U) * 1e6 / up_mean  # trace IS the uplink
        down_row = None
        if cfg.model == "trace" and cfg.trace_down:
            drow = np.asarray(
                cfg.trace_down[round_idx % len(cfg.trace_down)], float)
            down_row = np.resize(drow, U)
        return fade, down_row

    def sample(self, round_idx: int) -> LinkState:
        cfg, U = self.cfg, self.U
        up_mean = cfg.mean_uplink_mbps * 1e6
        down_mean = cfg.mean_downlink_mbps * 1e6
        if cfg.model == "ideal":
            inf = np.full(U, np.inf)
            return LinkState(inf, inf, np.zeros(U))
        fade, down_row = self.fades(round_idx)
        up = np.maximum(up_mean * self._scale * fade, 1.0)
        down = np.maximum(down_mean * self._scale * fade, 1.0)
        if down_row is not None:
            # a measured downlink trace (round-major, cycled, resized — the
            # same shape rules as ``trace``) is honored as-is.  Without one,
            # the ``down`` above is the documented FALLBACK: the uplink
            # trace rescaled by the configured mean downlink/uplink ratio —
            # fabricated fading perfectly correlated with the uplink; record
            # a trace_down pair whenever up/down asymmetry matters.
            down = np.maximum(down_row * 1e6 * self._scale, 1.0)
        return LinkState(up, down, np.full(U, cfg.latency_s))

    # -------------------------------------------------------- contention --
    def contended_uplink(self, link: LinkState, active: np.ndarray,
                         es_assign: np.ndarray) -> np.ndarray:
        """Effective uplink rates when each ES's uplink is a SHARED pipe.

        The ``active`` (scheduled) clients of one ES split its capacity
        ``es_uplink_mbps``; each client gets the smaller of its own link
        rate and its share, so the per-ES aggregate never exceeds the ES
        capacity.  ``WirelessConfig.contention`` picks the sharing rule:
        ``"equal"`` gives every active client the same share,
        ``"proportional"`` weights shares by the clients' PRIVATE rates and
        WATER-FILLS (:func:`waterfill_shares`): a client whose private link
        saturates below its proportional share is capped at its link rate
        and the excess re-shares among its capacity-hungry peers, so a
        finite pipe is never stranded behind a slow client's cap.  (With
        private-rate weights the share/limit ratio ``cap / sum(rates)`` is
        the same for every active client of an ES, so all of them cap
        together or none do and the water-filling reduces to the one-shot
        proportional split — the redistribution only bites for weight
        profiles that differ from the limits, but the invariant "per-ES
        aggregate <= cap, no strandable excess" now holds for any of them.)
        Inactive clients keep their private rate (they do not transmit, so
        they occupy no share).  An ideal channel or an infinite ES capacity
        bypasses contention entirely.
        """
        cap = self.cfg.es_uplink_mbps * 1e6
        if self.cfg.model == "ideal" or not np.isfinite(cap):
            return link.uplink_bps
        active = np.asarray(active, bool)
        es = np.asarray(es_assign, int)
        if self.cfg.contention == "proportional":
            share = waterfill_shares(cap, link.uplink_bps, link.uplink_bps,
                                     es, active)
        else:                                    # "equal"
            counts = np.bincount(es[active], minlength=es.max() + 1)
            share = cap / np.maximum(counts[es], 1)
        return np.where(active, np.minimum(link.uplink_bps, share),
                        link.uplink_bps)

    # ------------------------------------------------------ time / energy --
    def round_time_s(self, link: LinkState, bits: RoundBits) -> np.ndarray:
        """Per-client completion time of one edge round's traffic."""
        with np.errstate(divide="ignore"):
            t_up = bits.uplink / link.uplink_bps
            t_down = bits.downlink / link.downlink_bps
        return 2 * link.latency_s + t_up + t_down

    def round_energy_j(self, link: LinkState, bits: RoundBits) -> np.ndarray:
        """Per-client uplink transmit energy (P_tx * airtime), UNCAPPED.

        This is the full-transmission estimate; the scheduler's
        authoritative charge is its deadline-capped timeline charge (which
        also adds compute joules) — see the scheduler docstring's timeline
        straggler semantics."""
        with np.errstate(divide="ignore"):
            t_up = bits.uplink / link.uplink_bps
        return self.cfg.tx_power_w * np.where(np.isfinite(t_up), t_up, 0.0)


def waterfill_shares(cap: float, weights: np.ndarray, limits: np.ndarray,
                     groups: np.ndarray, active: np.ndarray) -> np.ndarray:
    """Weighted proportional shares of ``cap`` per group, water-filled.

    Each group's capacity ``cap`` is split among its active members in
    proportion to ``weights``; a member whose ``limits`` (e.g. its private
    link rate) falls below its share is CAPPED there, and the capacity it
    cannot use re-shares among the remaining uncapped members by the same
    weights — repeated until no new member caps (at most one new cap per
    pass, so at most U passes; in practice the loop exits after one or
    two).  Guarantees, per group: every active member's share <= its limit;
    the aggregate over active members <= cap; and the aggregate equals
    ``min(cap, sum of active limits)`` whenever weights are positive, i.e.
    no capacity is stranded while some member could still use more.  The
    first pass is exactly the one-shot ``cap * w / sum(w)`` split, so when
    nothing caps the result is bit-identical to it.

    Returns the (U,) share array; entries of inactive members are their
    (uncapped, unclaimed) one-shot shares and should be ignored.
    """
    weights = np.asarray(weights, float)
    limits = np.asarray(limits, float)
    groups = np.asarray(groups, int)
    active = np.asarray(active, bool)
    ngroups = groups.max() + 1 if groups.size else 1
    capped = np.zeros(weights.shape, bool)
    share = np.full(weights.shape, cap, float)
    for _ in range(weights.size):
        w_unc = np.where(active & ~capped, weights, 0.0)
        totals = np.bincount(groups, weights=w_unc, minlength=ngroups)
        used = np.bincount(groups,
                           weights=np.where(active & capped, limits, 0.0),
                           minlength=ngroups)
        remaining = np.maximum(cap - used, 0.0)
        share = remaining[groups] * weights / np.maximum(totals[groups], 1.0)
        newly = active & ~capped & (limits <= share)
        if not newly.any():
            break
        capped |= newly
    return np.where(active & capped, limits, share)
