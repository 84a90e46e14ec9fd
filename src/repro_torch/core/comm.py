"""Communication-overhead accounting (paper Remark 1).

All quantities in BITS.  omega = floating-point mantissa-ish precision
parameter as in [4]; payload per float = (omega + 1) bits.

  Phi_local  = N_b * { 2[(N * Z_c)(omega+1)] + N * (ceil(log2 |D_u|) + 1) }
      per local round: N_b minibatches, each shipping o_fp up, o_bp down
      (the 2x), plus the sampled indices.
  Phi_off    = Z_0 * (omega + 1)
      client-side model offload (one direction).
  Phi_PHSFL <= kappa0 * Phi_local + 2 * Phi_off       (Eq. 17)
  Phi_HFL    = 2 * Z * (omega + 1)
      classic HFL ships the whole model down + up.

PHSFL wins iff Phi_HFL > Phi_PHSFL, typically because Z >> Z_0 + Z_c.

Compression (repro_torch.compress): each of the three wire payloads — cut-layer
activations up (act_codec), cut-layer gradients down (grad_codec), and the
client-block offload (off_codec) — may carry a Codec whose
``payload_bits(n_elements)`` replaces the hardcoded ``(omega+1)`` bits per
element.  ``None`` keeps the paper's full-precision accounting exactly.

The PyTorch port's copy of ``repro.core.comm``.  The reference counts
parameters with ``jax.eval_shape``; here the models build their trees on
the meta device (``models.init_utils.shape_generator``), so a full-width
LM is counted from its shapes alone and no weight is drawn.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import TYPE_CHECKING, Optional

if TYPE_CHECKING:
    from repro_torch.compress import Codec, LinkCodecs


@dataclass(frozen=True)
class CommModel:
    omega: int = 32              # bits per float payload (omega+1 with sign)
    batch_size: int = 32         # N
    batches_per_epoch: int = 5   # minibatches per local epoch
    cut_size: int = 0            # Z_c: cut-layer activation elements per sample
    client_params: int = 0       # Z_0
    total_params: int = 0        # Z
    dataset_size: int = 1        # |D_u,ft|
    client_flops_per_sample: float = 0.0  # training (fwd+bwd) FLOPs the
    #                              client block burns per sample at this cut
    #                              (the device model's compute twin of Z_c)
    # per-payload codecs (None = the paper's (omega+1)-bit accounting)
    act_codec: Optional["Codec"] = None    # o_fp, client -> ES
    grad_codec: Optional["Codec"] = None   # o_bp, ES -> client
    off_codec: Optional["Codec"] = None    # client-block offload

    def _payload(self, codec, n_elements: int) -> int:
        # None and a width-deferring IdentityCodec both mean: this model's
        # own (omega+1) bits per element — exact for any omega
        if codec is None or getattr(codec, "bits_per_element", 0) is None:
            return n_elements * (self.omega + 1)
        return codec.payload_bits(n_elements)

    def phi_activation_bits(self) -> int:
        """One direction of one minibatch's cut-layer tensor at FULL
        precision (the codec-free Remark-1 reference)."""
        return self.batch_size * self.cut_size * (self.omega + 1)

    def phi_activation_up_bits(self) -> int:
        """One minibatch's o_fp on the wire, through act_codec."""
        return self._payload(self.act_codec, self.batch_size * self.cut_size)

    def phi_grad_down_bits(self) -> int:
        """One minibatch's o_bp on the wire, through grad_codec."""
        return self._payload(self.grad_codec, self.batch_size * self.cut_size)

    def phi_indices_bits(self) -> int:
        return self.batch_size * (math.ceil(math.log2(max(self.dataset_size, 2))) + 1)

    def phi_local_bits(self) -> int:
        per_batch = (self.phi_activation_up_bits()
                     + self.phi_grad_down_bits() + self.phi_indices_bits())
        return self.batches_per_epoch * per_batch

    def phi_off_bits(self) -> int:
        return self._payload(self.off_codec, self.client_params)

    def phi_phsfl_bits(self, kappa0: int) -> int:
        """Eq. (17) upper bound for one edge aggregation round."""
        return kappa0 * self.phi_local_bits() + 2 * self.phi_off_bits()

    def phi_hfl_bits(self) -> int:
        return 2 * self.total_params * (self.omega + 1)

    def phsfl_wins(self, kappa0: int) -> bool:
        return self.phi_hfl_bits() > self.phi_phsfl_bits(kappa0)


def _codec_fields(codecs) -> dict:
    if codecs is None:
        return {}
    return dict(act_codec=codecs.activations, grad_codec=codecs.gradients,
                off_codec=codecs.offload)


def comm_for_cnn(cfg, dataset_size: int, *, omega: int = 32,
                 batch_size: int = 32, batches_per_epoch: int = 5,
                 cut: str | None = None,
                 codecs: Optional["LinkCodecs"] = None) -> CommModel:
    """Instantiate the comm model from the paper's CNN split at ``cut``."""
    from repro_torch.core.split import count_parts, split_spec_for
    from repro_torch.models import cnn as cnn_mod
    from repro_torch.utils.flops import training_flops

    cut = cut if cut is not None else cnn_mod.DEFAULT_CUT
    params = cnn_mod.param_shapes(cfg)
    counts = count_parts(params, split_spec_for(cfg, cut))
    z_c = cnn_mod.cut_activation_size(cfg, 1, cut)
    flops = training_flops(cnn_mod.client_block_flops(cfg, 1, cut))
    return CommModel(omega=omega, batch_size=batch_size,
                     batches_per_epoch=batches_per_epoch, cut_size=z_c,
                     client_params=counts["client"],
                     total_params=sum(counts.values()),
                     dataset_size=dataset_size,
                     client_flops_per_sample=flops, **_codec_fields(codecs))


def comm_for_lm(cfg, seq_len: int, dataset_size: int, *, omega: int = 16,
                batch_size: int = 8, batches_per_epoch: int = 1,
                cut: int | None = None,
                codecs: Optional["LinkCodecs"] = None) -> CommModel:
    """Comm model for an LM architecture (cut after ``cut`` blocks, default
    ``cfg.n_client_layers``).  The config is rebuilt at the requested cut so
    the lead (unscanned) stage always covers the client block and the
    Z_0 count is exact for any candidate depth."""
    import dataclasses

    from repro_torch.core.split import count_parts, split_spec_for
    from repro_torch.models.init_utils import shape_generator
    from repro_torch.models.registry import build_model
    from repro_torch.utils.flops import dense_model_flops

    if cut is not None and cut != cfg.n_client_layers:
        if cfg.encdec is not None:
            # the encoder-decoder client block is the modality frontend
            # (src_proj + embed), not a depth prefix — every depth candidate
            # would price the SAME (Z_0, Z_c) cell and the cut controller
            # would "adapt" over indistinguishable candidates
            raise ValueError(
                "encoder-decoder archs have a frontend-based split; "
                "cut-depth candidates are not supported")
        cfg = dataclasses.replace(cfg, n_client_layers=int(cut))
    params = build_model(cfg).init(shape_generator())
    counts = count_parts(params, split_spec_for(cfg))
    z_c = seq_len * cfg.d_model            # cut activations per sample
    # the standard 6ND training estimate over the client block's params,
    # per sample = seq_len tokens (utils.flops.dense_model_flops)
    flops = dense_model_flops(counts["client"], seq_len)
    return CommModel(omega=omega, batch_size=batch_size,
                     batches_per_epoch=batches_per_epoch, cut_size=z_c,
                     client_params=counts["client"],
                     total_params=sum(counts.values()),
                     dataset_size=dataset_size,
                     client_flops_per_sample=flops, **_codec_fields(codecs))


def _cross_codecs(cuts, codecs, one_cell):
    """Build a per-cut table, or a (cut, codec_name)-keyed cut x codec table
    when ``codecs`` is a dict of named LinkCodecs (cut-major order, so the
    CutController's deepest-feasible search walks cuts first)."""
    if isinstance(codecs, dict):
        return {(c, name): one_cell(c, lc)
                for c in cuts for name, lc in codecs.items()}
    return {c: one_cell(c, codecs) for c in cuts}


def comm_table_for_cnn(cfg, dataset_size: int, *,
                       cuts: tuple[str, ...] | None = None,
                       codecs=None, **kw) -> dict:
    """Per-cut ``(Z_0, Z_c)`` table over the CNN's candidate cuts, shallow to
    deep — the byte side of the ASFL-style cut-selection knob.  ``codecs``
    is a single :class:`repro_torch.compress.LinkCodecs` applied to every cut, or
    a dict of named LinkCodecs producing the cut x codec bit table keyed by
    ``(cut, codec_name)``.  An empty ``cuts`` tuple means all candidates."""
    from repro_torch.models import cnn as cnn_mod

    cuts = cuts if cuts else cnn_mod.CUT_CANDIDATES
    return _cross_codecs(cuts, codecs,
                         lambda c, lc: comm_for_cnn(cfg, dataset_size, cut=c,
                                                    codecs=lc, **kw))


def comm_table_for_lm(cfg, seq_len: int, dataset_size: int, *,
                      cuts: tuple[int, ...], codecs=None, **kw) -> dict:
    """Per-cut table over candidate ``n_client_layers`` depths for an LM
    (same ``codecs`` semantics as :func:`comm_table_for_cnn`).  The LM has
    no default candidate list, so an empty ``cuts`` tuple is an error."""
    if not cuts:
        raise ValueError("comm_table_for_lm needs at least one candidate "
                         "client depth in cuts=")
    return _cross_codecs(tuple(int(c) for c in cuts), codecs,
                         lambda c, lc: comm_for_lm(cfg, seq_len, dataset_size,
                                                   cut=c, codecs=lc, **kw))
