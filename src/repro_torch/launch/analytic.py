"""Analytic per-(arch x shape x mesh) cost model for the roofline terms
(``repro.launch.analytic``), expression for expression, so that every
float equals the reference's.

The reference keeps this model because XLA's HloCostAnalysis counts a
while-loop body once, not times its trip count.  The port's dry run
traces eagerly, so its traced FLOPs count every loop at its trip count;
it records them beside these numbers (``roofline.analyze``) as a
cross-check, and the roofline's terms stay the analytic ones.

``attn_impl``: "masked" counts attention over the whole (S x S)
rectangle, as the reference's pure-JAX attention computes it (its
``analyze`` passes "masked"); "flash" counts the causal half, as a
kernel that skips the blocks above the diagonal and outside the window
does.  The port's attention is K2, which skips them, so the port's dry
run passes "flash".

All quantities are PER CHIP unless suffixed _global.
Conventions: multiply-add = 2 FLOPs; bf16 = 2 bytes; f32 = 4 bytes.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

from repro_torch.configs.base import (ATTN, LOCAL_ATTN, MLA_ATTN, MLSTM, RGLRU,
                                SLSTM, ModelConfig, ShapeConfig, TrainConfig)

BF16 = 2
F32 = 4


# --------------------------------------------------------- per-layer flops --
def _attn_flops_per_token(cfg: ModelConfig, kv_len: float, *, causal_half: bool
                          ) -> float:
    """Projection + mixing FLOPs for one token through one attention layer."""
    d, qd, kvd, h, hd = (cfg.d_model, cfg.q_dim, cfg.kv_dim, cfg.num_heads,
                         cfg.head_dim)
    proj = 2 * d * (qd + 2 * kvd) + 2 * qd * d
    eff = kv_len / 2 if causal_half else kv_len
    mixing = 2 * 2 * h * hd * eff                      # qk^T and att@v
    return proj + mixing


def _mla_flops_per_token(cfg: ModelConfig, kv_len: float, *, causal_half: bool
                         ) -> float:
    m = cfg.mla
    d, h = cfg.d_model, cfg.num_heads
    qk = m.qk_nope_head_dim + m.qk_rope_head_dim
    proj = 2 * d * m.q_lora_rank + 2 * m.q_lora_rank * h * qk \
        + 2 * d * (m.kv_lora_rank + m.qk_rope_head_dim) \
        + 2 * m.kv_lora_rank * h * (m.qk_nope_head_dim + m.v_head_dim) \
        + 2 * h * m.v_head_dim * d
    eff = kv_len / 2 if causal_half else kv_len
    mixing = 2 * h * (qk + m.v_head_dim) * eff
    return proj + mixing


def _ffn_flops_per_token(cfg: ModelConfig, layer_is_moe: bool, dense_ff: int
                         ) -> float:
    d = cfg.d_model
    if layer_is_moe:
        moe = cfg.moe
        f = 2 * d * moe.num_experts                    # router
        f += moe.top_k * 3 * 2 * d * moe.d_ff_expert
        if moe.num_shared_experts:
            f += 3 * 2 * d * moe.d_ff_shared * moe.num_shared_experts
        return f
    return 3 * 2 * d * dense_ff if dense_ff else 0.0


def _recurrent_flops_per_token(cfg: ModelConfig, kind: str) -> float:
    d = cfg.d_model
    if kind == RGLRU:
        w = cfg.rglru.lru_width or d
        return (2 * d * w * 2          # in_x, in_gate
                + 2 * w * w * 2        # w_a, w_x
                + 2 * cfg.rglru.conv_kernel * w
                + 8 * w                # gate math + recurrence
                + 2 * w * d)           # out
    xl = cfg.xlstm
    if kind == MLSTM:
        di = int(d * xl.proj_factor_mlstm)
        dh = di // xl.num_heads
        chunk = 256
        mixing = xl.num_heads * (2 * 2 * chunk * dh / 2      # intra (causal)
                                 + 2 * 2 * dh * dh / chunk)  # carry in/out
        return (2 * d * 2 * di + 3 * 2 * di * di
                + 2 * cfg.xlstm.conv_kernel * di + mixing + 2 * di * d)
    if kind == SLSTM:
        dh = d // xl.num_heads
        dff = int(d * xl.proj_factor_slstm)
        return (2 * d * 4 * d + xl.num_heads * 2 * dh * 4 * dh
                + 20 * d + 3 * 2 * d * dff)
    raise ValueError(kind)


def _layer_flops_per_token(cfg: ModelConfig, layer_id: int, kv_len: float, *,
                           causal_half: bool) -> float:
    kinds = cfg.layer_kinds()
    kind = kinds[layer_id]
    is_moe = cfg.moe is not None and layer_id >= (cfg.moe.first_dense_layers or 0)
    dense_ff = cfg.d_ff
    if cfg.moe is not None and not is_moe:
        dense_ff = cfg.moe.d_ff_dense
    if kind in (SLSTM, MLSTM):
        return _recurrent_flops_per_token(cfg, kind)
    if kind == RGLRU:
        return _recurrent_flops_per_token(cfg, kind) \
            + _ffn_flops_per_token(cfg, is_moe, dense_ff)
    if kind == MLA_ATTN:
        f = _mla_flops_per_token(cfg, kv_len, causal_half=causal_half)
    else:
        eff = min(kv_len, cfg.sliding_window) if kind == LOCAL_ATTN and \
            cfg.sliding_window else kv_len
        f = _attn_flops_per_token(cfg, eff,
                                  causal_half=causal_half and eff == kv_len)
    return f + _ffn_flops_per_token(cfg, is_moe, dense_ff)


def forward_flops_per_token(cfg: ModelConfig, kv_len: float, *,
                            causal_half: bool = False) -> float:
    """One token through the whole model (embeddings + layers + head)."""
    total = 2 * cfg.d_model * cfg.padded_vocab            # lm head
    for lid in range(cfg.num_layers):
        total += _layer_flops_per_token(cfg, lid, kv_len,
                                        causal_half=causal_half)
    if cfg.encdec is not None:
        # encoder layers over the source sequence, amortized per target token
        src = cfg.encdec.max_source_len
        enc = cfg.encdec.num_encoder_layers * (
            _attn_flops_per_token(cfg, src, causal_half=False)
            + _ffn_flops_per_token(cfg, False, cfg.d_ff))
        total += enc * src / max(kv_len, 1)
        # cross attention (already excluded from decoder loop approximations)
        total += cfg.num_layers * 2 * 2 * cfg.num_heads * cfg.head_dim * src
    return total


# ------------------------------------------------------------- whole step --
@dataclass
class AnalyticCost:
    flops: float            # per chip
    hbm_bytes: float        # per chip
    coll_bytes: float       # per chip
    detail: dict


def param_bytes_global(cfg: ModelConfig, dtype_bytes: int = BF16) -> float:
    """The parameters of ``build_model(cfg).init``, counted on the meta
    device (nothing is allocated), times ``dtype_bytes``."""
    return param_count(cfg) * dtype_bytes


@functools.lru_cache(maxsize=None)
def param_count(cfg: ModelConfig) -> int:
    """Elements of every leaf of ``build_model(cfg).init``, on the meta
    device."""
    from repro_torch.core.phsfl import abstract_params
    from repro_torch.models.registry import build_model
    from repro_torch.utils.tree import tree_leaves

    return sum(t.numel() for t in tree_leaves(
        abstract_params(build_model(cfg))))


def train_cost(cfg: ModelConfig, shape: ShapeConfig, mesh_shape: dict, *,
               tcfg: TrainConfig | None = None,
               mode: str = "paper_faithful",
               attn_impl: str = "masked",
               agg_dtype_bytes: int = F32) -> AnalyticCost:
    """The PHSFL edge round: k_local fused steps + hierarchical aggregation.

    attn_impl: "masked" — the full (S x S) rectangle, masked (the
    reference's baseline); "flash" — K2 skips above-diagonal /
    out-of-window blocks (~2x mixing-FLOP saving for causal full
    attention).
    """
    tcfg = tcfg or TrainConfig()
    tp = mesh_shape.get("model", 1)
    clients = mesh_shape.get("data", 1) * mesh_shape.get("pod", 1)
    chips = tp * clients
    k = tcfg.local_steps_in_step
    micro = shape.global_batch // (clients * k)
    tokens_per_client = k * micro * shape.seq_len

    fwd = forward_flops_per_token(cfg, shape.seq_len,
                                  causal_half=(attn_impl == "flash"))
    # fwd + 2x bwd (+ recompute): full remat re-runs the whole forward
    # (+1.0); 'dots' policy saves matmul outputs and recomputes only the
    # cheap elementwise ops (~+0.3)
    if not tcfg.remat:
        mult = 3.0
    elif tcfg.remat_policy == "dots":
        mult = 3.3
    else:
        mult = 4.0
    flops_client = fwd * mult * tokens_per_client
    flops_chip = flops_client / tp

    pbytes = param_bytes_global(cfg)
    if mode == "paper_faithful":
        pbytes_chip = pbytes / tp              # one replica per client, TP'd
    else:
        pbytes_chip = pbytes / chips           # FSDP body (client block tiny)
    # traffic: read params fwd+bwd(+recompute), write update, grads rw;
    # activations: remat checkpoints written+read once per microbatch
    act_bytes = (cfg.num_layers * micro * shape.seq_len * cfg.d_model
                 * BF16 * 2) * k
    hbm = pbytes_chip * (mult + 2.0) * k + act_bytes

    # collectives per chip:
    # (1) TP all-reduces: ~4 per layer per microbatch of (micro,seq,d) bf16,
    #     ring factor 2(n-1)/n ~= 2
    coll_tp = 4 * cfg.num_layers * k * micro * shape.seq_len * cfg.d_model \
        * BF16 * 2 * (tp - 1) / max(tp, 1) if tp > 1 else 0.0
    # (2) edge aggregation: all-reduce of the trained params over 'data'
    nd = mesh_shape.get("data", 1)
    agg_bytes = pbytes_chip / BF16 * agg_dtype_bytes
    coll_edge = agg_bytes * 2 * (nd - 1) / nd if nd > 1 else 0.0
    if mode == "shared_server":
        # only the client block ships on the kappa0 boundary; body grads
        # all-reduce every step instead (approximately same magnitude as one
        # param all-reduce per step)
        coll_edge = coll_edge * 0.02 + agg_bytes * 2 * (nd - 1) / nd * k
    npod = mesh_shape.get("pod", 1)
    coll_pod = agg_bytes * 2 * (npod - 1) / npod if npod > 1 else 0.0
    coll = coll_tp + coll_edge + coll_pod

    return AnalyticCost(
        flops=flops_chip, hbm_bytes=hbm, coll_bytes=coll,
        detail={"tokens_per_client": tokens_per_client, "micro": micro,
                "param_bytes_per_chip": pbytes_chip,
                "coll_tp": coll_tp, "coll_edge": coll_edge,
                "coll_pod": coll_pod, "mode": mode})


def prefill_cost(cfg: ModelConfig, shape: ShapeConfig, mesh_shape: dict, *,
                 attn_impl: str = "masked",
                 param_mode: str = "fsdp_tp") -> AnalyticCost:
    tp = mesh_shape.get("model", 1)
    dp = mesh_shape.get("data", 1) * mesh_shape.get("pod", 1)
    chips = tp * dp
    batch_local = max(shape.global_batch // dp, 1)
    tokens_local = batch_local * shape.seq_len
    fwd = forward_flops_per_token(cfg, shape.seq_len,
                                  causal_half=(attn_impl == "flash"))
    flops_chip = fwd * tokens_local / tp
    pbytes_resident = param_bytes_global(cfg) / (chips if param_mode ==
                                                 "fsdp_tp" else tp)
    act = batch_local * shape.seq_len * cfg.d_model * BF16 * cfg.num_layers
    # fsdp all-gather of params (each chip gathers the other shards) + TP ARs
    coll_fsdp = (param_bytes_global(cfg) / chips) * (dp - 1) \
        if (dp > 1 and param_mode == "fsdp_tp") else 0.0
    coll_tp = 4 * cfg.num_layers * tokens_local * cfg.d_model * BF16 \
        * 2 * (tp - 1) / tp if tp > 1 else 0.0
    return AnalyticCost(
        flops=flops_chip,
        hbm_bytes=pbytes_resident + act,
        coll_bytes=coll_fsdp + coll_tp,
        detail={"batch_local": batch_local, "coll_fsdp": coll_fsdp,
                "coll_tp": coll_tp, "param_mode": param_mode})


def decode_cost(cfg: ModelConfig, shape: ShapeConfig, mesh_shape: dict, *,
                param_mode: str = "fsdp_tp") -> AnalyticCost:
    """One decode step with a seq_len-deep cache.

    param_mode: "fsdp_tp" — weights sharded over all axes, all-gathered per
    step (baseline serving layout); "tp" — weights TP-resident (replicated
    over the data axes), no per-step weight all-gather at dp x the weight
    memory.
    """
    tp = mesh_shape.get("model", 1)
    dp = mesh_shape.get("data", 1) * mesh_shape.get("pod", 1)
    chips = tp * dp
    batch_local = max(shape.global_batch // dp, 1)
    fwd = forward_flops_per_token(cfg, shape.seq_len, causal_half=False)
    flops_chip = fwd * batch_local / tp

    pbytes_resident = param_bytes_global(cfg) / (chips if param_mode ==
                                                 "fsdp_tp" else tp)
    cache_chip = _cache_bytes_global(cfg, shape) / chips
    hbm = pbytes_resident + cache_chip            # read weights + read cache
    coll_fsdp = (param_bytes_global(cfg) / chips) * (dp - 1) \
        if (dp > 1 and param_mode == "fsdp_tp") else 0.0
    coll_tp = 4 * cfg.num_layers * batch_local * cfg.d_model * BF16 \
        * 2 * (tp - 1) / tp if tp > 1 else 0.0
    return AnalyticCost(
        flops=flops_chip, hbm_bytes=hbm, coll_bytes=coll_fsdp + coll_tp,
        detail={"cache_bytes_per_chip": cache_chip,
                "param_bytes_resident_per_chip": pbytes_resident,
                "param_mode": param_mode, "coll_fsdp": coll_fsdp,
                "coll_tp": coll_tp})


def _cache_bytes_global(cfg: ModelConfig, shape: ShapeConfig) -> float:
    b, s = shape.global_batch, shape.seq_len
    total = 0.0
    for kind in cfg.layer_kinds():
        if kind == ATTN:
            total += b * s * cfg.kv_dim * 2 * BF16
        elif kind == LOCAL_ATTN:
            total += b * min(s, cfg.sliding_window) * cfg.kv_dim * 2 * BF16
        elif kind == MLA_ATTN:
            m = cfg.mla
            total += b * s * (m.kv_lora_rank + m.qk_rope_head_dim) * BF16
        elif kind == RGLRU:
            w = cfg.rglru.lru_width or cfg.d_model
            total += b * w * F32
        elif kind == MLSTM:
            di = int(cfg.d_model * cfg.xlstm.proj_factor_mlstm)
            dh = di // cfg.xlstm.num_heads
            total += b * cfg.xlstm.num_heads * (dh * dh + dh) * F32
        elif kind == SLSTM:
            total += b * cfg.d_model * 4 * F32
    if cfg.encdec is not None:
        total += b * cfg.encdec.max_source_len * cfg.kv_dim * 2 * BF16 \
            * cfg.num_layers
    return total


def cost_for(cfg: ModelConfig, shape: ShapeConfig, mesh_shape: dict, *,
             mode: str = "paper_faithful", attn_impl: str = "masked",
             param_mode: str = "fsdp_tp", agg_dtype_bytes: int = F32,
             tcfg: TrainConfig | None = None) -> AnalyticCost:
    if shape.kind == "train":
        return train_cost(cfg, shape, mesh_shape, mode=mode, tcfg=tcfg,
                          attn_impl=attn_impl, agg_dtype_bytes=agg_dtype_bytes)
    if shape.kind == "prefill":
        return prefill_cost(cfg, shape, mesh_shape, attn_impl=attn_impl,
                            param_mode=param_mode)
    return decode_cost(cfg, shape, mesh_shape, param_mode=param_mode)
