"""GQA attention: the dense path, the flash path (K2) and the KV-cache
decode (``repro.models.attention``).

Path selection (``impl``):
  - ``"auto"`` and ``"flash"``: the flash attention wrapper
    (``repro_torch.hopper.flash_attention.ops``), K2 on the card.  The
    reference's "auto" picks its pure-JAX chunked and banded paths above
    ``DENSE_MAX_SEQ`` tokens to bound memory; K2's forward does that
    itself, so the port has neither as a forward path.
  - ``"dense"``: the masked softmax below.  K2's backward differentiates
    it: whole up to ``DENSE_MAX_SEQ`` tokens, and above that by query
    blocks of ``Q_CHUNK`` rows over only the keys a block can see (the
    reference's banded path on a windowed layer, ``q_offset`` shifting the
    positions), so its live memory is O(Q_CHUNK x keys), not O(S^2).
  - decode (one token): dense tensor code over the cache, as in the
    reference; no kernel.
  - cross-attention (``attn_apply(kv_override=)``, the encoder-decoder's
    decoder over the encoder's memory): the dense path whatever
    ``impl``.  Its queries and keys have different lengths, which K2
    (like the reference's Pallas kernel) does not take; the reference's
    "auto" sends it to its dense path too (at most ``DENSE_MAX_SEQ``
    query rows, the lengths the zoo runs).

Layouts as the reference: x (B,S,D); q (B,S,H,hd), k/v (B,S,KV,hd);
weights q (D,H,hd), k/v (D,KV,hd), o (H*hd, D).
"""

from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.hopper.flash_attention.ops import flash_attention
from repro_torch.models.init_utils import dense, dense_axes, norm, norm_axes
from repro_torch.models.layers import apply_mrope, apply_norm, apply_rope

DENSE_MAX_SEQ = 4096          # longest seq K2's backward recomputes whole
Q_CHUNK = 1024                # query rows a block of the blocked recompute
NEG_INF = -2.0 ** 30          # large-negative instead of -inf (NaN-safe masks)


# ------------------------------------------------------------- params ------
def attn_init(gen: torch.Generator, cfg: ModelConfig, dtype=None) -> dict:
    dtype = dtype or getattr(torch, cfg.dtype)
    p = {
        "q": dense(gen, cfg.d_model, (cfg.num_heads, cfg.head_dim),
                   bias=cfg.attn_bias, dtype=dtype),
        "k": dense(gen, cfg.d_model, (cfg.num_kv_heads, cfg.head_dim),
                   bias=cfg.attn_bias, dtype=dtype),
        "v": dense(gen, cfg.d_model, (cfg.num_kv_heads, cfg.head_dim),
                   bias=cfg.attn_bias, dtype=dtype),
        "o": dense(gen, cfg.num_heads * cfg.head_dim, cfg.d_model,
                   dtype=dtype,
                   scale=1.0 / math.sqrt(cfg.num_heads * cfg.head_dim)),
    }
    if cfg.qk_norm:
        p["q_norm"] = norm(cfg.head_dim, "rmsnorm", dtype, gen.device)
        p["k_norm"] = norm(cfg.head_dim, "rmsnorm", dtype, gen.device)
    return p


def attn_axes(cfg: ModelConfig) -> dict:
    a = {"q": dense_axes(("embed", "heads", "head_dim"), bias=cfg.attn_bias),
         "k": dense_axes(("embed", "kv_heads", "head_dim"),
                         bias=cfg.attn_bias),
         "v": dense_axes(("embed", "kv_heads", "head_dim"),
                         bias=cfg.attn_bias),
         "o": dense_axes(("heads", "embed"))}
    if cfg.qk_norm:
        a["q_norm"] = norm_axes("rmsnorm")
        a["k_norm"] = norm_axes("rmsnorm")
    return a


def _proj(x, w):
    """(B,S,D) x (D,heads,hd) -> (B,S,heads,hd), one matmul."""
    d, h, hd = w.shape
    return (x @ w.reshape(d, h * hd)).unflatten(-1, (h, hd))


def _project(p, cfg: ModelConfig, x, name: str):
    """x: (B,S,D) -> the ``name`` ("q", "k" or "v") heads (B,S,heads,hd),
    with its bias, and for q and k the qk-norm where the config has it."""
    t = _proj(x, p[name]["w"])
    if cfg.attn_bias:
        t = t + p[name]["b"]
    if cfg.qk_norm and name != "v":
        t = apply_norm(p[f"{name}_norm"], t, "rmsnorm")
    return t


def _project_qkv(p, cfg: ModelConfig, x):
    """x: (B,S,D) -> q (B,S,H,hd), k/v (B,S,KV,hd)."""
    return tuple(_project(p, cfg, x, name) for name in ("q", "k", "v"))


def _out_proj(p, cfg: ModelConfig, o):
    """o: (B,S,H,hd) -> (B,S,D)."""
    b, s = o.shape[:2]
    return o.reshape(b, s, cfg.num_heads * cfg.head_dim) @ p["o"]["w"]


# ---------------------------------------------------------- core maths -----
def _expand_gqa(q, num_kv: int):
    """(B,S,H,hd) -> (B,S,KV,G,hd)."""
    b, s, h, d = q.shape
    return q.reshape(b, s, num_kv, h // num_kv, d)


def _mask_bias(qpos, kpos, *, causal: bool, window: int, kv_valid=None):
    """Additive float32 mask bias (..., q, k) from absolute positions."""
    qp = qpos[..., :, None]
    kp = kpos[..., None, :]
    keep = torch.ones(torch.broadcast_shapes(qp.shape, kp.shape),
                      dtype=torch.bool, device=qp.device)
    if causal:
        keep &= kp <= qp
    if window:
        keep &= kp > qp - window
    if kv_valid is not None:
        keep &= kv_valid[..., None, :]
    return _bias(keep)


def _bias(keep):
    zero = torch.zeros((), dtype=torch.float32, device=keep.device)
    return torch.where(keep, zero, torch.full_like(zero, NEG_INF))


def dense_attention(q, k, v, *, causal: bool, window: int, softcap: float,
                    q_offset=0, kv_valid=None):
    """Reference masked-softmax attention.

    q: (B,Sq,H,hd); k,v: (B,Sk,KV,hd).  q_offset: absolute position of q[0]
    (int or (B,) tensor).  kv_valid: optional (B,Sk) bool.
    """
    b, sq, h, d = q.shape
    sk, kv_heads = k.shape[1], k.shape[2]
    qg = _expand_gqa(q, kv_heads)                        # (B,Sq,KV,G,hd)
    scale = 1.0 / math.sqrt(d)
    logits = torch.einsum("bqngd,bknd->bngqk",
                          qg.to(torch.float32) * scale, k.to(torch.float32))
    if softcap:
        logits = torch.tanh(logits / softcap) * softcap
    qpos = (torch.arange(sq, device=q.device)[None, :]
            + torch.as_tensor(q_offset, device=q.device).reshape(-1, 1))
    kpos = torch.arange(sk, device=q.device)[None, :].expand(b, sk)
    bias = _mask_bias(qpos, kpos, causal=causal, window=window,
                      kv_valid=kv_valid)                 # (B,q,k)
    logits = logits + bias[:, None, None, :, :]
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bngqk,bknd->bqngd", probs, v.to(torch.float32))
    return out.reshape(b, sq, h, v.shape[-1]).to(q.dtype)


def self_attention(q, k, v, *, causal: bool = True, window: int = 0,
                   softcap: float = 0.0, impl: str = "auto"):
    """Full-sequence self-attention: K2 under "auto"/"flash", the dense
    masked softmax under "dense"."""
    if impl in ("auto", "flash"):
        return flash_attention(q, k, v, causal=causal, window=window,
                               softcap=softcap)
    if impl == "dense":
        return dense_attention(q, k, v, causal=causal, window=window,
                               softcap=softcap)
    raise ValueError(f"unknown attention impl {impl!r}; "
                     f"use 'auto', 'flash' or 'dense'")


def _rotate_one(x, cfg: ModelConfig, theta: float, positions, positions3):
    """RoPE on x (q or k) at ``positions`` (B,S), or M-RoPE at
    ``positions3`` (B,S,3) when given (the VLM's text and patch
    positions)."""
    if positions3 is not None:
        return apply_mrope(x, positions3, theta, cfg.vlm.mrope_sections)
    return apply_rope(x, positions, theta)


def _rotate(q, k, cfg: ModelConfig, theta: float, positions, positions3):
    """``_rotate_one`` on q and on k."""
    return (_rotate_one(q, cfg, theta, positions, positions3),
            _rotate_one(k, cfg, theta, positions, positions3))


def attn_apply(p, cfg: ModelConfig, x, *, window: int = 0,
               rope_theta: float = 10000.0, softcap: float = 0.0,
               positions=None, positions3=None, causal: bool = True,
               kv_override=None, impl: str = "auto"):
    """Full-sequence attention sublayer: proj -> rope (M-RoPE with
    ``positions3``) -> attn -> out proj.

    kv_override: (k, v) from another sequence (cross-attention, from
    ``cross_kv``): only q is projected and rotated, and attention is the
    dense path (module docstring)."""
    b, s, _ = x.shape
    if kv_override is not None:
        q = _project(p, cfg, x, "q")
        k, v = kv_override
    else:
        q, k, v = _project_qkv(p, cfg, x)
    if rope_theta or positions3 is not None:
        pos = positions if positions is not None \
            else torch.arange(s, device=x.device)[None].expand(b, s)
        if kv_override is None:
            q, k = _rotate(q, k, cfg, rope_theta, pos, positions3)
        else:                   # the memory's keys take no rotation
            q = _rotate_one(q, cfg, rope_theta, pos, positions3)
    if kv_override is None:
        out = self_attention(q, k, v, causal=causal, window=window,
                             softcap=softcap, impl=impl)
    else:
        out = dense_attention(q, k, v, causal=causal, window=window,
                              softcap=softcap)
    return _out_proj(p, cfg, out)


def cross_kv(p, cfg: ModelConfig, memory):
    """Cross-attention k and v (B,S_src,KV,hd) from the encoder's memory
    (B,S_src,D)."""
    k = _proj(memory, p["k"]["w"])
    v = _proj(memory, p["v"]["w"])
    if cfg.attn_bias:
        k = k + p["k"]["b"]
        v = v + p["v"]["b"]
    return k, v


# ------------------------------------------------------------ KV cache -----
def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int, *,
                  window: int = 0, dtype=torch.bfloat16, device="cpu"):
    """Cache for one attention layer.  Sliding-window layers keep only a
    rolling ``window``-sized buffer."""
    length = min(window, max_len) if window else max_len
    shape = (batch, length, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def cache_axes() -> dict:
    return {"k": (None, "length", "kv_heads", "head_dim"),
            "v": (None, "length", "kv_heads", "head_dim")}


def decode_attend(p, cfg: ModelConfig, x, cache, index: int, *, window: int,
                  rope_theta: float, softcap: float = 0.0, positions3=None):
    """One-token decode: write this token's k/v into the cache, attend over
    the valid slots.

    x: (B,1,D); index: number of tokens already in the cache;
    positions3: optional (B,1,3) M-RoPE position ids of this token (in
    place of ``index``'s RoPE).  Writes the
    cache in place (the reference returns a new one; here the update saves
    a copy of every layer's cache per token) and returns (out (B,1,D),
    cache).
    """
    b = x.shape[0]
    q, k, v = _project_qkv(p, cfg, x)
    if rope_theta or positions3 is not None:
        pos = torch.full((b, 1), index, dtype=torch.int32, device=x.device)
        q, k = _rotate(q, k, cfg, rope_theta, pos, positions3)

    ck, cv = cache["k"], cache["v"]
    length = ck.shape[1]
    slot = index % length if window else min(index, length - 1)
    ck[:, slot] = k[:, 0].to(ck.dtype)
    cv[:, slot] = v[:, 0].to(cv.dtype)

    slots = torch.arange(length, device=x.device)
    if window:
        # ring buffer: slot s holds position index - ((slot - s) mod length)
        kpos = index - torch.remainder(slot - slots, length)
        valid = ((kpos >= 0) & (kpos >= index - window + 1)) | (slots == slot)
    else:
        valid = slots <= index
    kv_valid = valid[None].expand(b, length)

    qg = _expand_gqa(q, cfg.num_kv_heads)                 # (B,1,KV,G,hd)
    scale = 1.0 / math.sqrt(cfg.head_dim)
    logits = torch.einsum("bqngd,bknd->bngqk",
                          qg.to(torch.float32) * scale, ck.to(torch.float32))
    if softcap:
        logits = torch.tanh(logits / softcap) * softcap
    logits = logits + _bias(kv_valid)[:, None, None, None, :]
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bngqk,bknd->bqngd", probs, cv.to(torch.float32))
    out = out.reshape(b, 1, cfg.num_heads, cfg.head_dim).to(x.dtype)
    return _out_proj(p, cfg, out), cache
