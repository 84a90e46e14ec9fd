"""Per-round, channel-aware cut-layer selection (ASFL-style).

The paper's Remark 2 proves the cut-layer choice does not change learning
dynamics; Remark 1 shows it changes who pays which bits — the cut trades the
per-minibatch activation tensor (N * Z_c, shrinking as the cut deepens in
the CNN) against the client-block offload (Z_0, growing with depth).  That
makes the cut a pure resource-allocation knob, and this module is the
controller that turns per-round channel state into a per-client cut choice:

- ``fixed``:    every client always uses one declared cut (the pre-cutter
                behavior, now just the degenerate policy);
- ``greedy``:   per client, the cut with the smallest ESTIMATED round time
                whose uplink energy the client can still afford (per-client
                argmin of time subject to the energy budget);
- ``deadline``: per client, the DEEPEST affordable cut that still makes the
                edge-round deadline at the offered rate — deeper cuts ship
                fewer activation bits per minibatch but a bigger client
                block, so under a tight deadline the controller walks down
                exactly as far as the channel allows.

The candidate list may also be a joint (cut, codec) GRID: a CommModel table
built with a dict of named ``repro_torch.compress.LinkCodecs`` prices every
cut x codec cell, and ``decide`` searches the flat cell list under the same
greedy/deadline policies — compression is just more candidate cells with
fewer bits.  ``cut_pos``/``codec_pos`` map the chosen cell index back to
its cut depth and codec so reports stay interpretable.

Every cell also carries its client-side FLOPs (``CutSpec.flops``, from
``repro_torch.wireless.device.client_round_flops``): given a device model's
``sec_per_flop``, ``decide`` prices each candidate's COMPUTE time and
energy next to its bits — the full ASFL computation+communication
trade-off, under which a deep cut's smaller activation tensor is no longer
free for a compute-starved client.

The controller is stateless: :class:`~repro_torch.wireless.scheduler.
ParticipationScheduler` calls :meth:`CutController.decide` twice per round —
once on the private (uncontended) rates to make scheduling decisions, and
again on the contended per-ES rates so ``deadline``/``greedy`` adapt to the
bandwidth actually available after the ES uplink is shared.

The port's copy of ``repro.wireless.cutter``: numpy, as in the reference,
with its imports pointed at the port.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.core.comm import CommModel
from repro_torch.wireless.channel import RoundBits, client_round_bits

POLICIES = ("fixed", "greedy", "deadline")


@dataclass(frozen=True)
class CutSpec:
    """One candidate (cut, codec) cell: name + Remark-1 byte accounting."""
    name: str | int          # "conv1" (CNN) or n_client_layers (LM)
    bits: RoundBits          # per-edge-round traffic at this cut x codec
    z0: int                  # Z_0: client-block parameters
    z_c: int                 # Z_c: cut-layer activation elements per sample
    codec: str = "fp32"      # codec-set name ("fp32" = uncompressed)
    flops: float = 0.0       # per-edge-round client compute at this cell
    #                          (client-block training + codec work)


def cut_specs(comms: dict, kappa0: int, *,
              codec_cycles_per_element: float = 0.0) -> tuple[CutSpec, ...]:
    """Build the candidate list from a per-cut CommModel table (the output
    of ``comm_table_for_cnn`` / ``comm_table_for_lm``), preserving its
    shallow-to-deep order.  Tables built with a codecs dict key their cells
    ``(cut, codec_name)``; plain tables get the ``"fp32"`` codec label.
    Each cell also carries its client-side FLOPs so the controller can price
    compute alongside bits (``repro_torch.wireless.device``)."""
    from repro_torch.wireless.device import client_round_flops

    specs = []
    for key, cm in comms.items():
        assert isinstance(cm, CommModel)
        name, codec = key if isinstance(key, tuple) else (key, "fp32")
        specs.append(CutSpec(
            name=name, bits=client_round_bits(cm, kappa0),
            z0=cm.client_params, z_c=cm.cut_size, codec=codec,
            flops=client_round_flops(
                cm, kappa0,
                codec_cycles_per_element=codec_cycles_per_element)))
    return tuple(specs)


class CutController:
    """Maps per-client link state to a per-client candidate-cut index."""

    def __init__(self, specs: tuple[CutSpec, ...], policy: str = "fixed", *,
                 fixed_cut: int = 0, deadline_s: float = float("inf"),
                 tx_power_w: float = 0.5, compute_power_w: float = 0.0,
                 pipeline: bool = False, expected_attempts: float = 1.0,
                 harq_backoff_s: float = 0.0):
        if policy not in POLICIES:
            raise ValueError(f"unknown cut policy {policy!r}; one of {POLICIES}")
        if expected_attempts < 1.0:
            raise ValueError(f"expected_attempts must be >= 1, got "
                             f"{expected_attempts}")
        if not specs:
            raise ValueError("need at least one candidate cut")
        if not 0 <= fixed_cut < len(specs):
            raise ValueError(f"fixed_cut {fixed_cut} out of range for "
                             f"{len(specs)} candidates")
        self.specs = tuple(specs)
        self.policy = policy
        self.fixed_cut = fixed_cut
        self.deadline_s = deadline_s
        self.tx_power_w = tx_power_w
        self.compute_power_w = compute_power_w
        self.pipeline = pipeline
        # HARQ pricing (repro_torch.wireless.faults.expected_attempts): under an
        # erasure channel every transmission repeats ``expected_attempts``
        # times in expectation, with a backoff gap before each retry —
        # adaptive policies must price retransmissions BEFORE they happen
        # or they systematically pick cuts the channel cannot carry
        self.expected_attempts = float(expected_attempts)
        self.harq_backoff_s = float(harq_backoff_s)
        self.up_bits = np.array([s.bits.uplink for s in specs], np.float64)
        self.down_bits = np.array([s.bits.downlink for s in specs], np.float64)
        self.flops = np.array([s.flops for s in specs], np.float64)
        # minibatch decomposition of the uplink (pipelined streaming): every
        # cell shares one chunk count (kappa0 * batches_per_epoch of the one
        # comm table); cells without it degenerate to a single chunk, under
        # which the pipelined estimates equal the serial ones exactly
        if all(s.bits.up_stream is not None for s in specs):
            self.up_stream = np.array([s.bits.up_stream for s in specs],
                                      np.float64)
            self.up_tail = np.array([s.bits.up_tail for s in specs],
                                    np.float64)
            chunkset = {int(s.bits.chunks) for s in specs}
            assert len(chunkset) == 1, \
                f"cells disagree on chunk count: {sorted(chunkset)}"
            self.chunks = chunkset.pop()
        else:
            self.up_stream = self.up_bits
            self.up_tail = np.zeros(len(specs))
            self.chunks = 1
        # joint (cut, codec) grids: map each spec index back to its cut
        # position (shallow -> deep) and its codec position, so reports can
        # say WHICH split and WHICH codec a client got, not just the cell
        self.cut_names = tuple(dict.fromkeys(s.name for s in specs))
        self.codec_names = tuple(dict.fromkeys(s.codec for s in specs))
        self.cut_pos = np.array([self.cut_names.index(s.name) for s in specs])
        self.codec_pos = np.array([self.codec_names.index(s.codec)
                                   for s in specs])

    @property
    def num_cuts(self) -> int:
        return len(self.specs)

    @property
    def has_codec_grid(self) -> bool:
        """True when the candidate grid spans more than one codec set."""
        return len(self.codec_names) > 1

    def bits_for(self, cuts: np.ndarray) -> RoundBits:
        """Per-client (uplink, downlink) bit arrays for a cut-index vector,
        carrying the minibatch decomposition the pipelined timeline needs."""
        cuts = np.asarray(cuts, int)
        return RoundBits(uplink=self.up_bits[cuts],
                         downlink=self.down_bits[cuts],
                         up_stream=self.up_stream[cuts],
                         up_tail=self.up_tail[cuts], chunks=self.chunks)

    def flops_for(self, cuts: np.ndarray) -> np.ndarray:
        """Per-client client-side FLOPs for a cut-index vector."""
        return self.flops[np.asarray(cuts, int)]

    # ------------------------------------------------------------ policy --
    def _estimates(self, up_bps, down_bps, latency_s, sec_per_flop=None):
        """(num_cuts, U) estimated round time and client energy matrices.

        ``sec_per_flop`` (a (U,) array from ``DeviceModel.sec_per_flop``)
        prices each cell's client-side COMPUTE alongside its bits: a deeper
        cut ships fewer activation bits but burns more client FLOPs, and
        only with both terms does the controller see the full ASFL
        trade-off.  ``None`` (or all-zero, i.e. infinite compute) reproduces
        the bits-only estimates exactly.

        With ``pipeline=True`` the TIME estimate prices the overlapped
        streaming timeline instead of the serial sum: per-chunk compute
        ``c = t_comp / chunks`` and per-payload airtime ``u`` close to an
        uplink finish of ``c + u + (chunks-1)*max(c, u) + tail`` (see
        ``repro_torch.wireless.timeline``), which shifts every greedy/deadline
        (cut, codec) trade-off — a compute-heavy deep cut hides its FLOPs
        behind the radio.  The ENERGY estimate is unchanged: overlap moves
        segments earlier but the total compute and airtime (and therefore
        the joules) are identical."""
        with np.errstate(divide="ignore", invalid="ignore"):
            t_up = self.up_bits[:, None] / up_bps[None, :]
            t_down = self.down_bits[:, None] / down_bps[None, :]
        t_up = np.nan_to_num(t_up, nan=0.0)        # inf rate: 0 airtime
        t_down = np.nan_to_num(t_down, nan=0.0)
        # HARQ expansion: airtime repeats ea times in expectation; the TIME
        # also pays (ea - 1) backoff gaps, the ENERGY only the airtime (the
        # radio idles through backoff).  ea == 1, backoff == 0 leaves every
        # expression bit-untouched (fault-free pricing).
        ea, hb = self.expected_attempts, self.harq_backoff_s
        t_up_air = t_up
        harq = ea != 1.0 or hb != 0.0
        if harq:
            gap = (ea - 1.0) * hb
            t_up_air = ea * t_up
            t_up = t_up_air + gap
            t_down = ea * t_down + gap
        t_comp = 0.0
        if sec_per_flop is not None:
            t_comp = self.flops[:, None] * np.asarray(sec_per_flop)[None, :]
        if self.pipeline:
            with np.errstate(divide="ignore", invalid="ignore"):
                u = self.up_stream[:, None] / up_bps[None, :]
                t_tail = self.up_tail[:, None] / up_bps[None, :]
            u = np.nan_to_num(u, nan=0.0)
            t_tail = np.nan_to_num(t_tail, nan=0.0)
            if harq:
                # every stream payload and the tail repeat independently
                u = ea * u + gap
                t_tail = ea * t_tail + gap
            c = t_comp / self.chunks
            up_finish = c + u + (self.chunks - 1) * np.maximum(c, u) + t_tail
            times = 2 * np.asarray(latency_s)[None, :] + up_finish + t_down
        else:
            times = 2 * np.asarray(latency_s)[None, :] + t_up + t_down
            if sec_per_flop is not None:
                times = times + t_comp
        energy = self.tx_power_w * t_up_air
        if sec_per_flop is not None:
            energy = energy + self.compute_power_w * t_comp
        return times, energy

    def decide(self, up_bps, down_bps, latency_s, energy_left,
               sec_per_flop=None) -> np.ndarray:
        """Per-client candidate index under the configured policy.

        All policies fall back in two stages when their primary criterion is
        infeasible: an unaffordable/deadline-missing client first takes the
        fastest affordable cut, and a client that can afford NO cut takes
        the one with the least estimated energy (tx + compute joules at the
        full, uncapped workload).  The scheduler's gate then re-judges that
        pick against the DEADLINE-CAPPED charge it would actually deduct —
        a cell unaffordable at full airtime may still be scheduled as a
        straggler it can afford — so the choice here only has to be sane,
        not feasible.
        """
        U = np.asarray(up_bps).shape[0]
        if self.policy == "fixed" or self.num_cuts == 1:
            return np.full(U, self.fixed_cut, int)
        times, energy = self._estimates(np.asarray(up_bps, float),
                                        np.asarray(down_bps, float),
                                        np.broadcast_to(
                                            np.asarray(latency_s, float), (U,)),
                                        sec_per_flop)
        affordable = energy <= np.asarray(energy_left, float)[None, :]
        t_aff = np.where(affordable, times, np.inf)
        fastest_aff = np.argmin(t_aff, axis=0)     # greedy's primary answer
        cheapest = np.argmin(energy, axis=0)       # last-resort fallback
        none_affordable = ~affordable.any(axis=0)
        if self.policy == "greedy":
            return np.where(none_affordable, cheapest, fastest_aff)
        # deadline: deepest affordable cut meeting the deadline (candidates
        # are ordered shallow -> deep, so the highest feasible index wins;
        # on a cut x codec grid the cut-major order means the deepest cut
        # wins first and, within it, the LAST-listed feasible codec — list
        # codecs cheapest-last to prefer compression at the frontier)
        feasible = affordable & (times <= self.deadline_s)
        idx = np.arange(self.num_cuts)[:, None]
        deepest = np.where(feasible, idx, -1).max(axis=0)
        out = np.where(deepest >= 0, deepest, fastest_aff)
        return np.where(none_affordable, cheapest, out).astype(int)


def make_cut_controller(comms: dict, kappa0: int, *, policy: str = "fixed",
                        fixed_cut: int | str = 0,
                        deadline_s: float = float("inf"),
                        tx_power_w: float = 0.5,
                        compute_power_w: float = 0.0,
                        codec_cycles_per_element: float = 0.0,
                        pipeline: bool = False,
                        expected_attempts: float = 1.0,
                        harq_backoff_s: float = 0.0) -> CutController:
    """Convenience: per-cut CommModel table -> controller.

    ``fixed_cut`` may be a candidate NAME (e.g. ``"conv1"``, an LM depth, or
    a ``(cut, codec_name)`` cell of a cut x codec table — name matches win
    over index interpretation) instead of an index.  A bare cut name against
    a codec grid picks that cut's FIRST-listed codec.
    """
    specs = cut_specs(comms, kappa0,
                      codec_cycles_per_element=codec_cycles_per_element)
    cells = [(s.name, s.codec) for s in specs]
    names = [s.name for s in specs]
    if fixed_cut in cells:
        fixed_cut = cells.index(fixed_cut)
    elif fixed_cut in names:
        fixed_cut = names.index(fixed_cut)
    elif not (isinstance(fixed_cut, int) and 0 <= fixed_cut < len(specs)):
        raise ValueError(f"fixed_cut {fixed_cut!r} not among {cells}")
    return CutController(specs, policy, fixed_cut=fixed_cut,
                         deadline_s=deadline_s, tx_power_w=tx_power_w,
                         compute_power_w=compute_power_w, pipeline=pipeline,
                         expected_attempts=expected_attempts,
                         harq_backoff_s=harq_backoff_s)
