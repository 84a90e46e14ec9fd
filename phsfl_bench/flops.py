"""Model FLOPs and attention work, frozen from the port's analytic cost
model (``repro_torch.launch.analytic``: ``forward_flops_per_token`` and
the helpers it calls, for attention layers with a dense or MoE FFN and
the encoder-decoder) so that the yardstick does not move when the
program's copy is edited.  A multiply-add is 2 FLOPs; bfloat16 is 2
bytes.  Configurations are the benchmark's dicts.
"""

from __future__ import annotations


def padded_vocab(cfg: dict) -> int:
    return -(-cfg["vocab_size"] // 256) * 256


def _attn_per_token(cfg: dict, kv_len: float, causal_half: bool) -> float:
    d, h, hd = cfg["d_model"], cfg["num_heads"], cfg["head_dim"]
    qd, kvd = h * hd, cfg["num_kv_heads"] * hd
    proj = 2 * d * (qd + 2 * kvd) + 2 * qd * d
    eff = kv_len / 2 if causal_half else kv_len
    return proj + 2 * 2 * h * hd * eff


def _ffn_per_token(cfg: dict, is_moe: bool) -> float:
    d = cfg["d_model"]
    if is_moe:
        m = cfg["moe"]
        return (2 * d * m["num_experts"]
                + m["top_k"] * 3 * 2 * d * m["d_ff_expert"])
    return 3 * 2 * d * cfg["d_ff"]


def forward_per_token(cfg: dict, kv_len: float,
                      causal_half: bool = True) -> float:
    """One target token through the whole model, the head's 2 d V
    included (the encoder's work amortised over the target tokens)."""
    total = 2 * cfg["d_model"] * padded_vocab(cfg)
    is_moe = bool(cfg.get("moe"))
    for _ in range(cfg["num_layers"]):
        total += (_attn_per_token(cfg, kv_len, causal_half)
                  + _ffn_per_token(cfg, is_moe))
    enc = cfg.get("encdec")
    if enc:
        src = enc["max_source_len"]
        per = (_attn_per_token(cfg, src, False)
               + _ffn_per_token(cfg, False))
        total += enc["num_encoder_layers"] * per * src / max(kv_len, 1)
        total += (cfg["num_layers"] * 2 * 2 * cfg["num_heads"]
                  * cfg["head_dim"] * src)
    return total


def head_per_token(cfg: dict) -> float:
    return 2 * cfg["d_model"] * padded_vocab(cfg)


def train_step_flops(cfg: dict, tokens: int, seq: int) -> float:
    """A training step's model FLOPs: forward and backward (3x the
    forward) without recompute, less the frozen head's weight gradient
    (2 d V a token)."""
    return (3 * forward_per_token(cfg, seq) - head_per_token(cfg)) * tokens


def trunk_forward_flops(cfg: dict, tokens: int, seq: int) -> float:
    """The trunk's forward, the head's product left out."""
    return (forward_per_token(cfg, seq) - head_per_token(cfg)) * tokens


def head_step_flops(cfg: dict, tokens: int) -> float:
    """One SGD step on the head alone: the logits (2 d V a token) and the
    weight gradient (2 d V a token)."""
    return 2 * head_per_token(cfg) * tokens


def attention_pairs(s_q: int, s_k: int, causal: bool) -> int:
    return s_q * (s_q + 1) // 2 if causal else s_q * s_k


def self_attention_work(batch: int, seq: int, heads: int, kv_heads: int,
                        d: int, dv: int, causal: bool) -> tuple:
    """(FLOPs, bytes) of one self-attention forward: 2 (d + dv) FLOPs a
    (query, key) pair; q, k, v read once and o written once, bfloat16."""
    flops = 2 * (d + dv) * attention_pairs(seq, seq, causal) * batch * heads
    elems = batch * seq * (heads * d + kv_heads * d + kv_heads * dv
                           + heads * dv)
    return float(flops), float(2 * elems)
