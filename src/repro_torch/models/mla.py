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

Under tensor parallelism (``par``) the heads split over the "model" dim:
``q_b`` and ``kv_b`` by heads, ``o`` by its rows.  The latent path
(``q_a``, ``kv_a`` and their norms) is computed whole on every rank, and
the latents it yields (the query latent, ``c_kv`` and ``k_rope``) take
the gradient's sum over the dim (``copy_to_tp``) where the rank's heads
use them; ``o``'s partial product is summed (``reduce_from_tp``).  The
absorbed decode attends with the rank's heads over the whole latent
cache, or, at batch 1, over its slice of the cache's length, whose
partial softmax states are combined over the client dims as in
``attention.decode_attend``.  Heads that do not divide the dim are held
whole and computed whole.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.attention import (_bias, _proj, combine_split,
                                         self_attention)
from repro_torch.models.init_utils import dense, dense_axes, norm, norm_axes
from repro_torch.models.layers import apply_norm, apply_rope
from repro_torch.sharding import tensor_parallel as tpm


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


def _heads(p, cfg: ModelConfig, par):
    """(this rank's heads, whether its heads or ``o``'s rows are a block
    of the whole)."""
    hl = p["q_b"]["w"].shape[1]
    split = par is not None and par.tp and (
        hl < cfg.num_heads
        or p["o"]["w"].shape[0] < cfg.num_heads * cfg.mla.v_head_dim)
    return hl, split


def _project_q(p, cfg: ModelConfig, x, positions, par=None):
    m = cfg.mla
    qa = apply_norm(p["q_a_norm"], x @ p["q_a"]["w"], "rmsnorm")
    qa = tpm.copy_to_tp(qa, par)
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


def _out(p, cfg: ModelConfig, out, par, split: bool):
    """The heads' output (B,S,Hl*v) through ``o``: this rank's rows of
    it, summed over the "model" dim, when split."""
    if not split:
        return out @ p["o"]["w"]
    rows = p["o"]["w"].shape[0]
    if out.shape[-1] != rows:       # every head whole, o split by rows
        out = tpm.copy_to_tp(out, par)[
            ..., par.tp_rank * rows:(par.tp_rank + 1) * rows]
    return tpm.reduce_from_tp(out @ p["o"]["w"], par)


def mla_apply(p, cfg: ModelConfig, x, *, positions=None, causal: bool = True,
              impl: str = "auto", par=None):
    """Expanded-form full-sequence MLA (train / prefill): the rope and
    nope components of q and k concatenated into one head of nope + rope
    columns, v zero-padded to that width for the attention and sliced
    back after it.  ``par``: this rank's heads (module docstring)."""
    m = cfg.mla
    b, s, _ = x.shape
    hl, split = _heads(p, cfg, par)
    tp = par if hl < cfg.num_heads else None   # the latents feed a block
    pos = positions if positions is not None \
        else torch.arange(s, device=x.device)[None].expand(b, s)
    q_nope, q_rope = _project_q(p, cfg, x, pos, tp)
    c_kv, k_rope = (tpm.copy_to_tp(t, tp) for t in _latent_kv(p, cfg, x, pos))
    kvb = _proj(c_kv, p["kv_b"]["w"])
    k_nope = kvb[..., :m.qk_nope_head_dim]                # (B,S,Hl,nope)
    v = kvb[..., m.qk_nope_head_dim:]                     # (B,S,Hl,v)

    q = torch.cat([q_nope, q_rope], dim=-1)               # (B,S,Hl,nope+rope)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(
        *k_nope.shape[:3], m.qk_rope_head_dim)], dim=-1)
    v = F.pad(v, (0, q.shape[-1] - m.v_head_dim))
    out = self_attention(q, k, v, causal=causal, impl=impl)
    out = out[..., :m.v_head_dim].reshape(b, s, hl * m.v_head_dim)
    return _out(p, cfg, out, par, split)


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


def mla_decode_attend(p, cfg: ModelConfig, x, cache, index: int, par=None):
    """Absorbed-form one-token decode, in float32 as the reference.

    q_nope is pushed through W_uk so attention happens in latent space:
      logit_s = (q_nope W_uk) . c_kv[s] + q_rope . k_rope[s]
      out     = (sum_s p_s c_kv[s]) W_uv
    x: (B,1,D); index: tokens already in the cache.  Writes the cache in
    place and returns (out (B,1,D), cache).  ``par``: this rank's heads,
    and at batch 1 its slice of the cache's length (module docstring).
    """
    m = cfg.mla
    b = x.shape[0]
    hl, split = _heads(p, cfg, par)
    pos = torch.full((b, 1), index, dtype=torch.int32, device=x.device)
    q_nope, q_rope = _project_q(p, cfg, x, pos)           # (B,1,Hl,*)
    c_new, kr_new = _latent_kv(p, cfg, x, pos)            # (B,1,R), (B,1,rope)

    ck, kr = cache["c_kv"], cache["k_rope"]
    length = ck.shape[1]
    seq = par is not None and par.seq_size > 1 and length < par.cache_len
    first = par.seq_rank * length if seq else 0
    slot = min(index, (par.cache_len if seq else length) - 1)
    if first <= slot < first + length:
        ck[:, slot - first] = c_new[:, 0].to(ck.dtype)
        kr[:, slot - first] = kr_new[:, 0].to(kr.dtype)

    w_uk = p["kv_b"]["w"][..., :m.qk_nope_head_dim]       # (R,Hl,nope)
    w_uv = p["kv_b"]["w"][..., m.qk_nope_head_dim:]       # (R,Hl,v)
    q_lat = torch.einsum("bqhn,rhn->bqhr", q_nope, w_uk)  # (B,1,Hl,R)
    scale = 1.0 / math.sqrt(m.qk_nope_head_dim + m.qk_rope_head_dim)
    f32 = torch.float32
    logits = (torch.einsum("bqhr,bsr->bhqs", q_lat.to(f32), ck.to(f32))
              + torch.einsum("bqhd,bsd->bhqs", q_rope.to(f32),
                             kr.to(f32))) * scale
    valid = torch.arange(first, first + length, device=x.device) <= index
    logits = logits + _bias(valid)
    if seq:
        out_lat = combine_split(logits, lambda e: torch.einsum(
            "bhqs,bsr->bhqr", e, ck.to(f32)), par).transpose(1, 2)
    else:
        probs = torch.softmax(logits, dim=-1)
        out_lat = torch.einsum("bhqs,bsr->bqhr", probs, ck.to(f32))
    out = torch.einsum("bqhr,rhv->bqhv", out_lat, w_uv.to(f32))
    out = out.reshape(b, 1, hl * m.v_head_dim).to(x.dtype)
    return _out(p, cfg, out, par, split), cache
