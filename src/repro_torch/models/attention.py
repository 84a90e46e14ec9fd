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

Under tensor parallelism (``par``, ``sharding.tensor_parallel``) a rank
holds its block of each leaf: its query heads and the rows of ``o`` they
feed, its kv heads when they divide the "model" dim, else every kv head.
In that case it projects, before K2, only the kv heads its query heads
read (``tensor_parallel.kv_heads_for``), so K2's grouping sees whole
groups.  The block's input and every whole leaf it uses take the
gradient's sum over the dim (``copy_to_tp``), and ``o``'s partial
product is summed (``reduce_from_tp``).
"""

from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.hopper.flash_attention.ops import flash_attention
from repro_torch.models.init_utils import dense, dense_axes, norm, norm_axes
from repro_torch.models.layers import apply_mrope, apply_norm, apply_rope
from repro_torch.sharding import tensor_parallel as tpm

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


# ------------------------------------------------- tensor parallelism -----
def _tp_block(p, cfg: ModelConfig, x, par):
    """This rank's block as ``attn_apply`` uses it: (leaves, input, local
    query heads, whether ``o`` is split, the kv-head pick or None).
    Inside a split block the input and every leaf held whole (the q and k
    norms; q when the heads do not divide; k and v when the kv heads do
    not) take the gradient's sum over the "model" dim; with every kv head
    held, k and v narrow to those the rank's query heads read."""
    hl = p["q"]["w"].shape[1]
    o_split = p["o"]["w"].shape[0] < cfg.num_heads * cfg.head_dim
    kv_whole = p["k"]["w"].shape[1] == cfg.num_kv_heads
    if o_split:
        whole = {"q_norm", "k_norm"}
        if hl == cfg.num_heads:
            whole.add("q")
        if kv_whole:
            whole.update(("k", "v"))
        p = {name: {sub: tpm.copy_to_tp(t, par) for sub, t in d.items()}
             if name in whole else d for name, d in p.items()}
        x = tpm.copy_to_tp(x, par)
    pick = None
    if kv_whole and hl < cfg.num_heads:
        p, pick = _select_kv(p, cfg, par, hl)
    return p, x, hl, o_split, pick


def _select_kv(p, cfg: ModelConfig, par, hl: int):
    """k and v leaves narrowed to the kv heads this rank's ``hl`` query
    heads read, when the rank holds every kv head: (p, index list or
    None).  A slice keeps K2's grouping; otherwise the list names one kv
    head a query head, applied to k and v after projection."""
    pick = tpm.kv_heads_for(par, cfg.num_heads, cfg.num_kv_heads, hl)
    if isinstance(pick, list):
        return p, pick
    lo, hi = pick

    def narrow(d):
        out = {"w": d["w"][:, lo:hi]}
        if "b" in d:
            out["b"] = d["b"][lo:hi]
        return out

    return {**p, "k": narrow(p["k"]), "v": narrow(p["v"])}, None


def _out_rows(o, cfg: ModelConfig, p, par, hl: int):
    """This rank's rows of the attention output against its block of
    ``o``: its own heads, or, with every query head whole and ``o``
    split, the rows of its block (summed over the dim after)."""
    rows = p["o"]["w"].shape[0]
    b, s = o.shape[:2]
    flat = o.reshape(b, s, hl * cfg.head_dim)
    if hl * cfg.head_dim != rows:
        flat = flat[..., par.tp_rank * rows:(par.tp_rank + 1) * rows]
    return tpm.reduce_from_tp(flat @ p["o"]["w"], par)


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
               kv_override=None, impl: str = "auto", par=None):
    """Full-sequence attention sublayer: proj -> rope (M-RoPE with
    ``positions3``) -> attn -> out proj.

    kv_override: (k, v) from another sequence (cross-attention, from
    ``cross_kv``): only q is projected and rotated, and attention is the
    dense path (module docstring).  ``par``: this rank's tensor-parallel
    block (module docstring)."""
    b, s, _ = x.shape
    hl, o_split, pick = cfg.num_heads, False, None
    if par is not None and par.tp:
        p, x, hl, o_split, pick = _tp_block(p, cfg, x, par)
    if kv_override is not None:
        q = _project(p, cfg, x, "q")
        k, v = kv_override
    else:
        q, k, v = _project_qkv(p, cfg, x)
        if pick is not None:
            k, v = k[:, :, pick], v[:, :, pick]
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
    if o_split:
        return _out_rows(out, cfg, p, par, hl)
    return _out_proj(p, cfg, out)


def cross_kv(p, cfg: ModelConfig, memory, par=None):
    """Cross-attention k and v (B,S_src,KV,hd) from the encoder's memory
    (B,S_src,D).  ``par``: this rank's block as ``attn_apply`` takes it
    (``_tp_block``): the kv heads its query heads read, the memory and
    the whole leaves taking the gradient's sum over the "model" dim."""
    pick = None
    if par is not None and par.tp:
        p, memory, _, _, pick = _tp_block(p, cfg, memory, par)
    k = _proj(memory, p["k"]["w"])
    v = _proj(memory, p["v"]["w"])
    if cfg.attn_bias:
        k = k + p["k"]["b"]
        v = v + p["v"]["b"]
    if pick is not None:
        k, v = k[:, :, pick], v[:, :, pick]
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


def combine_split(logits, weighted, par):
    """Softmax attention over keys whose slots are split across the
    client dims (batch 1, ``par.seq_groups``): the max, the exponent sums
    and the weighted values (``weighted(e)``, the exponents' sum over
    this rank's keys against its values), float32, combined by
    ``all_reduce``.  logits: (..., keys), masked."""
    m = logits.amax(dim=-1, keepdim=True)
    for g in par.seq_groups:
        m = tpm.all_reduce_max(m, g)
    e = torch.exp(logits - m)
    state = tpm.all_reduce_sum(torch.cat([weighted(e), e.sum(
        -1, keepdim=True)], dim=-1), par.seq_groups)
    return state[..., :-1] / state[..., -1:]


def decode_attend(p, cfg: ModelConfig, x, cache, index: int, *, window: int,
                  rope_theta: float, softcap: float = 0.0, positions3=None,
                  par=None):
    """One-token decode: write this token's k/v into the cache, attend over
    the valid slots.

    x: (B,1,D); index: number of tokens already in the cache;
    positions3: optional (B,1,3) M-RoPE position ids of this token (in
    place of ``index``'s RoPE).  Writes the
    cache in place (the reference returns a new one; here the update saves
    a copy of every layer's cache per token) and returns (out (B,1,D),
    cache).

    ``par``: heads: the rank projects its query heads; its cache holds
    its kv heads, or every kv head when they do not divide the "model"
    dim (then it projects and writes all of them, keeping the replicated
    cache whole, and attends with those its query heads read).  Length
    (batch 1, ``par.seq_size`` > 1): slot ``s`` of the whole cache lies in
    slice ``s // Ls``; only its owner writes this token there, each rank
    attends over its slots (a sliding window's ring masked on absolute
    positions, so a window may span slices), and the partial softmax
    states (max, sum, weighted values; float32) are combined by
    ``all_reduce`` over the client dims.
    """
    b = x.shape[0]
    tp = par is not None and par.tp
    hl = p["q"]["w"].shape[1] if tp else cfg.num_heads
    o_split = tp and p["o"]["w"].shape[0] < cfg.num_heads * cfg.head_dim
    q, k, v = _project_qkv(p, cfg, x)
    if rope_theta or positions3 is not None:
        pos = torch.full((b, 1), index, dtype=torch.int32, device=x.device)
        q, k = _rotate(q, k, cfg, rope_theta, pos, positions3)

    ck, cv = cache["k"], cache["v"]
    length = ck.shape[1]
    whole_len = length
    if par is not None and par.seq_size > 1:
        whole_len = min(window, par.cache_len) if window else par.cache_len
    split = length < whole_len
    first = par.seq_rank * length if split else 0
    slot = index % whole_len if window else min(index, whole_len - 1)
    if first <= slot < first + length:
        ck[:, slot - first] = k[:, 0].to(ck.dtype)
        cv[:, slot - first] = v[:, 0].to(cv.dtype)

    slots = torch.arange(first, first + length, device=x.device)
    if window:
        # ring buffer: slot s holds position index - ((slot - s) mod length)
        kpos = index - torch.remainder(slot - slots, whole_len)
        valid = ((kpos >= 0) & (kpos >= index - window + 1)) | (slots == slot)
    else:
        valid = slots <= index
    kv_valid = valid[None].expand(b, length)

    out = attend_cache(q, ck, cv, kv_valid, cfg, par if tp else None,
                       par if split else None, softcap)
    if o_split:
        return _out_rows(out, cfg, p, par, hl), cache
    return _out_proj(p, cfg, out), cache


def attend_cache(q, ck, cv, kv_valid, cfg: ModelConfig, tp, seq,
                 softcap: float = 0.0):
    """One token's query heads q (B,1,Hl,hd) over a cache's keys and
    values (B,L,KV,hd), masked by ``kv_valid`` (B,L): (B,1,Hl,hd) in
    q's dtype.  ``tp``: the tensor-parallel block, whose query heads read
    only some of the kv heads when the cache holds every kv head.
    ``seq``: the block whose cache slots are split over the client dims
    (``combine_split``)."""
    b, _, hl, _ = q.shape
    keys, values = ck, cv
    if tp is not None and ck.shape[2] == cfg.num_kv_heads \
            and hl < cfg.num_heads:
        pick = tpm.kv_heads_for(tp, cfg.num_heads, cfg.num_kv_heads, hl)
        sel = list(range(*pick)) if isinstance(pick, tuple) else pick
        keys, values = ck[:, :, sel], cv[:, :, sel]
    qg = _expand_gqa(q, keys.shape[2])                    # (B,1,KV,G,hd)
    scale = 1.0 / math.sqrt(cfg.head_dim)
    logits = torch.einsum("bqngd,bknd->bngqk",
                          qg.to(torch.float32) * scale,
                          keys.to(torch.float32))
    if softcap:
        logits = torch.tanh(logits / softcap) * softcap
    logits = logits + _bias(kv_valid)[:, None, None, None, :]
    if seq is not None:
        out = combine_split(logits, lambda e: torch.einsum(
            "bngqk,bknd->bngqd", e, values.to(torch.float32)), seq)
        out = out.permute(0, 3, 1, 2, 4)
    else:
        probs = torch.softmax(logits, dim=-1)
        out = torch.einsum("bngqk,bknd->bqngd", probs,
                           values.to(torch.float32))
    return out.reshape(b, 1, hl, cfg.head_dim).to(q.dtype)
