"""Encoder-decoder backbone, seamless-m4t-medium (arXiv:2308.11596;
``repro.models.encdec``).

The audio frontend (mel-spectrogram + conv feature extractor) is the
allowed stub: the batch carries precomputed ``source_embeds`` (B, S_src,
d_model).  This module is the transformer encoder over them and the
autoregressive text/unit decoder: pre-norm self-attention (non-causal in
the encoder, causal in the decoder; K2 on the card), the decoder's
cross-attention over the encoder's memory (the dense path: its queries
and keys have different lengths, ``models.attention``), and the gated MLP.

The tree is the reference's: ``src_proj``, ``encoder`` and ``decoder``
stacked on a leading layer dimension (the reference's ``jax.vmap`` init,
walked by its ``lax.scan``; a loop here), ``enc_norm``, ``embed``,
``final_norm`` and ``lm_head``, so parameters carry across unchanged.

Where the numbers can differ from the reference: the frames are cast to
the model's dtype before ``src_proj`` (the VLM's patch embeddings are
cast the same way, in both packages).  The reference multiplies float32
frames into bfloat16 weights, which JAX promotes, so its encoder runs in
float32 under a bfloat16 config; the port's runs in the config's dtype,
on K2's bfloat16 path.  In float32 the two are the same arithmetic.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models.init_utils import dense, embedding, norm
from repro_torch.models.layers import apply_norm, mlp_apply, mlp_init
from repro_torch.models.transformer import logits_from_hidden, remat_wrapper
from repro_torch.utils.tree import tree_map


# ------------------------------------------------------------- layers ------
def _enc_layer_init(gen: torch.Generator, cfg: ModelConfig, dtype) -> dict:
    dev = gen.device
    return {"ln1": norm(cfg.d_model, cfg.norm, dtype, dev),
            "attn": attn_mod.attn_init(gen, cfg, dtype),
            "ln2": norm(cfg.d_model, cfg.norm, dtype, dev),
            "mlp": mlp_init(gen, cfg, dtype=dtype)}


def _dec_layer_init(gen: torch.Generator, cfg: ModelConfig, dtype) -> dict:
    dev = gen.device
    return {"ln1": norm(cfg.d_model, cfg.norm, dtype, dev),
            "self": attn_mod.attn_init(gen, cfg, dtype),
            "lnx": norm(cfg.d_model, cfg.norm, dtype, dev),
            "cross": attn_mod.attn_init(gen, cfg, dtype),
            "ln2": norm(cfg.d_model, cfg.norm, dtype, dev),
            "mlp": mlp_init(gen, cfg, dtype=dtype)}


def _stacked(layer_init, gen, cfg: ModelConfig, n: int, dtype) -> dict:
    layers = [layer_init(gen, cfg, dtype) for _ in range(n)]
    return tree_map(lambda *a: torch.stack(a), *layers)


def _layer(stacked, i: int):
    """Layer ``i``'s parameters: views into the stacked leaves."""
    return tree_map(lambda a: a[i], stacked)


# ------------------------------------------------------------- init --------
def init(gen: torch.Generator, cfg: ModelConfig, dtype=None) -> dict:
    """Random parameters drawn from ``gen`` on its device, in the
    reference's tree layout."""
    dtype = dtype or getattr(torch, cfg.dtype)
    d = cfg.d_model
    return {
        "src_proj": dense(gen, d, d, dtype=dtype),
        "encoder": _stacked(_enc_layer_init, gen, cfg,
                            cfg.encdec.num_encoder_layers, dtype),
        "enc_norm": norm(d, cfg.norm, dtype, gen.device),
        "embed": embedding(gen, cfg.padded_vocab, d, dtype),
        "decoder": _stacked(_dec_layer_init, gen, cfg, cfg.num_layers,
                            dtype),
        "final_norm": norm(d, cfg.norm, dtype, gen.device),
        "lm_head": dense(gen, d, cfg.padded_vocab, dtype=dtype),
    }


# ------------------------------------------------------------- apply -------
def encode(params, cfg: ModelConfig, source_embeds, *, impl: str = "auto",
           remat: bool = False, remat_policy: str | None = None):
    """The encoder's memory (B,S_src,D) from the frames (B,S_src,D); one
    checkpoint per layer under ``remat``."""
    w = params["src_proj"]["w"]
    x = source_embeds.to(w.dtype) @ w

    @remat_wrapper(remat, remat_policy)
    def layer(x, p):
        h = apply_norm(p["ln1"], x, cfg.norm)
        x = x + attn_mod.attn_apply(p["attn"], cfg, h, causal=False,
                                    rope_theta=cfg.rope_theta, impl=impl)
        h = apply_norm(p["ln2"], x, cfg.norm)
        return x + mlp_apply(p["mlp"], h, cfg.act)

    for i in range(cfg.encdec.num_encoder_layers):
        x = layer(x, _layer(params["encoder"], i))
    return apply_norm(params["enc_norm"], x, cfg.norm)


def apply(params, cfg: ModelConfig, batch, *, impl: str = "auto",
          remat: bool = False, remat_policy: str | None = None):
    """Teacher-forced full forward.  batch: {"source_embeds" (B,S_src,D),
    "tokens" (B,S)}.  Returns (decoder hidden states (B,S,D), aux = 0);
    one checkpoint per encoder and per decoder layer under ``remat``."""
    memory = encode(params, cfg, batch["source_embeds"], impl=impl,
                    remat=remat, remat_policy=remat_policy)
    x = F.embedding(batch["tokens"], params["embed"]["table"])

    @remat_wrapper(remat, remat_policy)
    def layer(x, p):
        h = apply_norm(p["ln1"], x, cfg.norm)
        x = x + attn_mod.attn_apply(p["self"], cfg, h, causal=True,
                                    rope_theta=cfg.rope_theta, impl=impl)
        h = apply_norm(p["lnx"], x, cfg.norm)
        kv = attn_mod.cross_kv(p["cross"], cfg, memory)
        x = x + attn_mod.attn_apply(p["cross"], cfg, h, causal=False,
                                    rope_theta=0.0, kv_override=kv,
                                    impl=impl)
        h = apply_norm(p["ln2"], x, cfg.norm)
        return x + mlp_apply(p["mlp"], h, cfg.act)

    for i in range(cfg.num_layers):
        x = layer(x, _layer(params["decoder"], i))
    x = apply_norm(params["final_norm"], x, cfg.norm)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


# ------------------------------------------------------------- decode ------
def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device="cpu") -> dict:
    """The decoder's self-attention KV cache, stacked over its layers, and
    the cross-attention k/v over ``max_source_len`` frames (zeros until
    ``precompute_cross`` fills them)."""
    nd, kv, hd = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
    shapes = {"self": (nd, batch, max_len, kv, hd),
              "cross": (nd, batch, cfg.encdec.max_source_len, kv, hd)}
    return {part: {name: torch.zeros(shape, dtype=dtype, device=device)
                   for name in ("k", "v")}
            for part, shape in shapes.items()}


def precompute_cross(params, cfg: ModelConfig, memory, dtype=torch.bfloat16):
    """The cross-attention cache {"k", "v"} (layers, B, S_src, KV, hd)
    from the encoder's memory."""
    ks, vs = [], []
    for i in range(cfg.num_layers):
        k, v = attn_mod.cross_kv(_layer(params["decoder"]["cross"], i), cfg,
                                 memory)
        ks.append(k.to(dtype))
        vs.append(v.to(dtype))
    return {"k": torch.stack(ks), "v": torch.stack(vs)}


def decode_step(params, cfg: ModelConfig, token, cache, index: int, *,
                positions3=None, return_hidden: bool = False):
    """One decoder step over the self cache, written in place, and the
    precomputed cross cache, attended densely.  token: (B,1).  Returns
    (logits (B,1,V), cache), or the final hidden state (B,1,D) in place of
    the logits with ``return_hidden``."""
    x = F.embedding(token, params["embed"]["table"])
    b = x.shape[0]
    for i in range(cfg.num_layers):
        p = _layer(params["decoder"], i)
        h = apply_norm(p["ln1"], x, cfg.norm)
        y, _ = attn_mod.decode_attend(
            p["self"], cfg, h, _layer(cache["self"], i), index, window=0,
            rope_theta=cfg.rope_theta)
        x = x + y
        h = apply_norm(p["lnx"], x, cfg.norm)
        # cross attention over the fixed encoder memory
        q = attn_mod._proj(h, p["cross"]["q"]["w"])
        if cfg.attn_bias:
            q = q + p["cross"]["q"]["b"]
        out = attn_mod.dense_attention(
            q, cache["cross"]["k"][i], cache["cross"]["v"][i], causal=False,
            window=0, softcap=0.0)
        x = x + (out.reshape(b, 1, cfg.num_heads * cfg.head_dim)
                 @ p["cross"]["o"]["w"])
        h = apply_norm(p["ln2"], x, cfg.norm)
        x = x + mlp_apply(p["mlp"], h, cfg.act)
    x = apply_norm(params["final_norm"], x, cfg.norm)
    if return_hidden:
        return x, cache
    return logits_from_hidden(params, cfg, x), cache
