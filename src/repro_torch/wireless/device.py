"""Per-client device (compute) model: FLOPs -> time and energy.

The paper's premise is that clients "have limited battery and computation
powers"; the channel model alone prices only *bits*, so a deeper cut —
which keeps more layers (and therefore more FLOPs) on the client — looked
free on the compute side.  This module is the compute twin of
:mod:`repro_torch.wireless.channel`:

- :func:`client_round_flops` is the sibling of ``client_round_bits``: the
  FLOPs ONE client burns per edge round at a given cut/codec choice —
  ``kappa0`` local epochs of client-block forward+backward per minibatch
  (``CommModel.client_flops_per_sample``, filled in by
  ``comm_for_cnn``/``comm_for_lm`` from the per-cut conv/dense counts in
  ``repro_torch.utils.flops``), plus the codec encode/decode work for every
  element that crosses a LOSSY codec (``codec_cycles_per_element``);
- :class:`DeviceModel` converts FLOPs to per-client TIME (a fixed lognormal
  compute-speed scale mirrors the channel's rate heterogeneity) and ENERGY
  (``compute_power_w`` joules per second of computing).

``compute_gflops=inf`` (the default) makes every conversion exactly zero,
reproducing the bits-only simulator bit-for-bit — that is the regression
anchor for the whole device model (tests/test_device.py).

The port's copy of ``repro.wireless.device``: numpy, as in the reference,
with its imports pointed at the port.
"""

from __future__ import annotations

import numpy as np

from repro_torch.configs.base import WirelessConfig
from repro_torch.core.comm import CommModel


def _codec_is_costly(codec) -> bool:
    """A payload costs codec compute only when a LOSSY codec transforms it:
    ``None`` and the identity passthrough move bits without touching them."""
    from repro_torch.compress import IdentityCodec
    return codec is not None and not isinstance(codec, IdentityCodec)


def client_round_flops(comm: CommModel, kappa0: int, *,
                       codec_cycles_per_element: float = 0.0) -> float:
    """Per-edge-round compute of ONE client — ``client_round_bits``'s twin.

    Training: kappa0 local epochs x batches_per_epoch minibatches of
    client-block forward+backward (``client_flops_per_sample`` per sample).
    Codec: every element crossing a lossy codec on the client side costs
    ``codec_cycles_per_element`` FLOPs — activations are ENCODED up and
    gradients DECODED down each minibatch, and the client block is encoded
    for the offload and decoded from the refresh broadcast (2 * Z_0).
    """
    n_batches = kappa0 * comm.batches_per_epoch
    flops = n_batches * comm.batch_size * comm.client_flops_per_sample
    if codec_cycles_per_element:
        act_elems = comm.batch_size * comm.cut_size
        elems = 0.0
        if _codec_is_costly(comm.act_codec):
            elems += n_batches * act_elems          # encode o_fp, uplink
        if _codec_is_costly(comm.grad_codec):
            elems += n_batches * act_elems          # decode o_bp, downlink
        if _codec_is_costly(comm.off_codec):
            elems += 2 * comm.client_params         # offload + refresh
        flops += codec_cycles_per_element * elems
    return float(flops)


class DeviceModel:
    """Converts per-round client FLOPs into per-client time and energy.

    Mirrors :class:`~repro_torch.wireless.channel.ChannelModel`'s construction:
    a fixed per-client lognormal compute-speed scale is drawn once (sigma =
    ``compute_heterogeneity``), from an RNG stream disjoint from the
    channel's (``seed + 2``) so enabling the device model never perturbs
    the fading draws.
    """

    def __init__(self, cfg: WirelessConfig, num_clients: int):
        if not cfg.compute_gflops > 0:       # rejects 0, negatives, and NaN
            # 0 would make sec_per_flop infinite and deadline-inf charges
            # NaN — every client silently unscheduled with no explanation
            raise ValueError(f"compute_gflops must be positive (inf = free "
                             f"compute), got {cfg.compute_gflops}")
        self.cfg = cfg
        self.U = num_clients
        rng = np.random.default_rng(cfg.seed + 2)
        if cfg.compute_heterogeneity > 0:
            self._scale = rng.lognormal(mean=0.0,
                                        sigma=cfg.compute_heterogeneity,
                                        size=num_clients)
        else:
            self._scale = np.ones(num_clients)
        self.flops_per_s = cfg.compute_gflops * 1e9 * self._scale
        # inf rate -> exactly 0 s/FLOP, so every downstream term vanishes
        self.sec_per_flop = np.where(np.isfinite(self.flops_per_s),
                                     1.0 / self.flops_per_s, 0.0)

    def compute_time_s(self, flops) -> np.ndarray:
        """Per-client seconds to burn ``flops`` (scalar or (U,))."""
        return np.asarray(flops, float) * self.sec_per_flop

    def chunk_time_s(self, flops, chunks: int) -> np.ndarray:
        """Per-client seconds of ONE minibatch chunk of a round's workload.

        The pipelined timeline (``repro_torch.wireless.timeline``) models the
        round's ``kappa0 * batches_per_epoch`` minibatches as EQUAL compute
        chunks — the client block runs the same forward+backward on every
        same-sized minibatch, so the split is uniform by construction."""
        return self.compute_time_s(flops) / max(int(chunks), 1)

    def compute_energy_j(self, compute_s) -> np.ndarray:
        """Joules drawn while computing for ``compute_s`` seconds."""
        return self.cfg.compute_power_w * np.asarray(compute_s, float)
