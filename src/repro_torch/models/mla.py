"""Multi-head Latent Attention (DeepSeek-V2, arXiv:2405.04434;
``repro.models.mla``).

Train and prefill use the *expanded* form; decode uses the *absorbed*
form, which attends directly in the kv_lora latent space: the decode
cache is (S, kv_lora + qk_rope) a layer instead of (S, H, 2 x head_dim).

The expanded form runs through ``attention.self_attention``, so K2 on the
card, with q and k of nope + rope columns (192 at deepseek's width).  Its
value heads are narrower (v_head_dim, 128), and K2 takes v of k's width:
v is zero-padded to the q/k width and the output sliced back.  That is
exact: the padded columns of every output row are sums of zeros, and the
softmax scale is 1/sqrt(nope + rope) either way.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.attention import _bias, _proj, self_attention
from repro_torch.models.init_utils import dense, dense_axes, norm, norm_axes
from repro_torch.models.layers import apply_norm, apply_rope


def mla_init(gen: torch.Generator, cfg: ModelConfig, dtype=None) -> dict:
    dtype = dtype or getattr(torch, cfg.dtype)
    m = cfg.mla
    h = cfg.num_heads
    return {
        # query path: d -> q_lora -> H*(nope+rope)
        "q_a": dense(gen, cfg.d_model, m.q_lora_rank, dtype=dtype),
        "q_a_norm": norm(m.q_lora_rank, "rmsnorm", dtype, gen.device),
        "q_b": dense(gen, m.q_lora_rank,
                     (h, m.qk_nope_head_dim + m.qk_rope_head_dim),
                     dtype=dtype),
        # kv path: d -> (kv_lora + rope)
        "kv_a": dense(gen, cfg.d_model, m.kv_lora_rank + m.qk_rope_head_dim,
                      dtype=dtype),
        "kv_a_norm": norm(m.kv_lora_rank, "rmsnorm", dtype, gen.device),
        "kv_b": dense(gen, m.kv_lora_rank,
                      (h, m.qk_nope_head_dim + m.v_head_dim), dtype=dtype),
        "o": dense(gen, h * m.v_head_dim, cfg.d_model, dtype=dtype,
                   scale=1.0 / math.sqrt(h * m.v_head_dim)),
    }


def mla_axes(cfg: ModelConfig) -> dict:
    return {"q_a": dense_axes(("embed", None)),
            "q_a_norm": norm_axes("rmsnorm"),
            "q_b": dense_axes((None, "heads", "head_dim")),
            "kv_a": dense_axes(("embed", None)),
            "kv_a_norm": norm_axes("rmsnorm"),
            "kv_b": dense_axes((None, "heads", "head_dim")),
            "o": dense_axes(("heads", "embed"))}


def _project_q(p, cfg: ModelConfig, x, positions):
    m = cfg.mla
    qa = apply_norm(p["q_a_norm"], x @ p["q_a"]["w"], "rmsnorm")
    q = _proj(qa, p["q_b"]["w"])                          # (B,S,H,nope+rope)
    q_nope = q[..., :m.qk_nope_head_dim]
    q_rope = apply_rope(q[..., m.qk_nope_head_dim:], positions, cfg.rope_theta)
    return q_nope, q_rope


def _latent_kv(p, cfg: ModelConfig, x, positions):
    m = cfg.mla
    kv = x @ p["kv_a"]["w"]                               # (B,S,kv_lora+rope)
    c_kv = apply_norm(p["kv_a_norm"], kv[..., :m.kv_lora_rank], "rmsnorm")
    k_rope = kv[..., None, m.kv_lora_rank:]               # (B,S,1,rope)
    k_rope = apply_rope(k_rope, positions, cfg.rope_theta)[..., 0, :]
    return c_kv, k_rope                                   # (B,S,R), (B,S,rope)


def mla_apply(p, cfg: ModelConfig, x, *, positions=None, causal: bool = True,
              impl: str = "auto"):
    """Expanded-form full-sequence MLA (train / prefill): the rope and
    nope components of q and k concatenated into one head of nope + rope
    columns, v zero-padded to that width for the attention and sliced
    back after it."""
    m = cfg.mla
    b, s, _ = x.shape
    pos = positions if positions is not None \
        else torch.arange(s, device=x.device)[None].expand(b, s)
    q_nope, q_rope = _project_q(p, cfg, x, pos)
    c_kv, k_rope = _latent_kv(p, cfg, x, pos)
    kvb = _proj(c_kv, p["kv_b"]["w"])
    k_nope = kvb[..., :m.qk_nope_head_dim]                # (B,S,H,nope)
    v = kvb[..., m.qk_nope_head_dim:]                     # (B,S,H,v)

    q = torch.cat([q_nope, q_rope], dim=-1)               # (B,S,H,nope+rope)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(
        *k_nope.shape[:3], m.qk_rope_head_dim)], dim=-1)
    v = F.pad(v, (0, q.shape[-1] - m.v_head_dim))
    out = self_attention(q, k, v, causal=causal, impl=impl)
    out = out[..., :m.v_head_dim].reshape(b, s, cfg.num_heads * m.v_head_dim)
    return out @ p["o"]["w"]


# --------------------------------------------------------------- decode ----
def init_mla_cache(cfg: ModelConfig, batch: int, max_len: int,
                   dtype=torch.bfloat16, device="cpu") -> dict:
    m = cfg.mla
    return {
        "c_kv": torch.zeros((batch, max_len, m.kv_lora_rank), dtype=dtype,
                            device=device),
        "k_rope": torch.zeros((batch, max_len, m.qk_rope_head_dim),
                              dtype=dtype, device=device),
    }


def mla_decode_attend(p, cfg: ModelConfig, x, cache, index: int):
    """Absorbed-form one-token decode, in float32 as the reference.

    q_nope is pushed through W_uk so attention happens in latent space:
      logit_s = (q_nope W_uk) . c_kv[s] + q_rope . k_rope[s]
      out     = (sum_s p_s c_kv[s]) W_uv
    x: (B,1,D); index: tokens already in the cache.  Writes the cache in
    place and returns (out (B,1,D), cache).
    """
    m = cfg.mla
    b = x.shape[0]
    pos = torch.full((b, 1), index, dtype=torch.int32, device=x.device)
    q_nope, q_rope = _project_q(p, cfg, x, pos)           # (B,1,H,*)
    c_new, kr_new = _latent_kv(p, cfg, x, pos)            # (B,1,R), (B,1,rope)

    ck, kr = cache["c_kv"], cache["k_rope"]
    length = ck.shape[1]
    slot = min(index, length - 1)
    ck[:, slot] = c_new[:, 0].to(ck.dtype)
    kr[:, slot] = kr_new[:, 0].to(kr.dtype)

    w_uk = p["kv_b"]["w"][..., :m.qk_nope_head_dim]       # (R,H,nope)
    w_uv = p["kv_b"]["w"][..., m.qk_nope_head_dim:]       # (R,H,v)
    q_lat = torch.einsum("bqhn,rhn->bqhr", q_nope, w_uk)  # (B,1,H,R)
    scale = 1.0 / math.sqrt(m.qk_nope_head_dim + m.qk_rope_head_dim)
    f32 = torch.float32
    logits = (torch.einsum("bqhr,bsr->bhqs", q_lat.to(f32), ck.to(f32))
              + torch.einsum("bqhd,bsd->bhqs", q_rope.to(f32),
                             kr.to(f32))) * scale
    valid = torch.arange(length, device=x.device) <= index
    logits = logits + _bias(valid)
    probs = torch.softmax(logits, dim=-1)
    out_lat = torch.einsum("bhqs,bsr->bqhr", probs, ck.to(f32))
    out = torch.einsum("bqhr,rhv->bqhv", out_lat, w_uv.to(f32))
    out = out.reshape(b, 1, cfg.num_heads * m.v_head_dim).to(x.dtype)
    return out @ p["o"]["w"], cache
