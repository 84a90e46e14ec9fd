"""Plain reference of the SeamlessM4T text encoder-decoder backbone
(arXiv:2308.11596): the parameter layout, the forward pass to the
decoder's final hidden states, and the training loss.  Nothing of the
port is imported.

The speech frontend is a stub, as in the configuration: the batch
carries frame embeddings (B, S_src, D), projected by ``src_proj``.
Encoder layer: x += self_attn(layernorm(x)) (non-causal, RoPE on q and
k); x += mlp(layernorm(x)).  Decoder layer: x += self_attn(layernorm(x))
(causal, RoPE); x += cross_attn(layernorm(x), memory) (keys and values
from the encoder's normed output, no rotation); x += mlp(layernorm(x)).
Every q, k and v projection has a bias; the MLP is gated (GELU, tanh
form).  Layers are stacked on a leading dim under ``encoder`` and
``decoder``.
"""

from __future__ import annotations

import math

import torch

from phsfl_bench.reference.common import (Numerics, gated_mlp, layernorm,
                                          lm_loss, self_attention)
from phsfl_bench.reference.decoder import _index, padded_vocab


def _attn_layout(cfg: dict, dtype, n: int) -> dict:
    d, h, kvh, hd = (cfg["d_model"], cfg["num_heads"], cfg["num_kv_heads"],
                     cfg["head_dim"])
    s = 1 / math.sqrt(d)
    return {"q/w": ((n, d, h, hd), dtype, s), "q/b": ((n, h, hd), dtype,
                                                      "zeros"),
            "k/w": ((n, d, kvh, hd), dtype, s), "k/b": ((n, kvh, hd), dtype,
                                                        "zeros"),
            "v/w": ((n, d, kvh, hd), dtype, s), "v/b": ((n, kvh, hd), dtype,
                                                        "zeros"),
            "o/w": ((n, h * hd, d), dtype, 1 / math.sqrt(h * hd))}


def _norm_layout(d: int, dtype, n=None) -> dict:
    lead = () if n is None else (n,)
    return {"scale": ((*lead, d), dtype, "ones"),
            "bias": ((*lead, d), dtype, "zeros")}


def _mlp_layout(cfg: dict, dtype, n: int) -> dict:
    d, f = cfg["d_model"], cfg["d_ff"]
    return {"gate/w": ((n, d, f), dtype, 1 / math.sqrt(d)),
            "up/w": ((n, d, f), dtype, 1 / math.sqrt(d)),
            "down/w": ((n, f, d), dtype, 1 / math.sqrt(f))}


def _under(prefix: str, lay: dict) -> dict:
    return {f"{prefix}/{k}": v for k, v in lay.items()}


def layout(cfg: dict) -> dict:
    """{path: (shape, dtype, init)}, as ``decoder.layout``."""
    dtype = getattr(torch, cfg["dtype"])
    d, v = cfg["d_model"], padded_vocab(cfg)
    ne, nd = cfg["encdec"]["num_encoder_layers"], cfg["num_layers"]
    out = {"src_proj/w": ((d, d), dtype, 1 / math.sqrt(d)),
           "embed/table": ((v, d), dtype, 1.0),
           "lm_head/w": ((d, v), dtype, 1 / math.sqrt(d))}
    out.update(_under("enc_norm", _norm_layout(d, dtype)))
    out.update(_under("final_norm", _norm_layout(d, dtype)))
    enc = {**_under("ln1", _norm_layout(d, dtype, ne)),
           **_under("attn", _attn_layout(cfg, dtype, ne)),
           **_under("ln2", _norm_layout(d, dtype, ne)),
           **_under("mlp", _mlp_layout(cfg, dtype, ne))}
    dec = {**_under("ln1", _norm_layout(d, dtype, nd)),
           **_under("self", _attn_layout(cfg, dtype, nd)),
           **_under("lnx", _norm_layout(d, dtype, nd)),
           **_under("cross", _attn_layout(cfg, dtype, nd)),
           **_under("ln2", _norm_layout(d, dtype, nd)),
           **_under("mlp", _mlp_layout(cfg, dtype, nd))}
    out.update(_under("encoder", enc))
    out.update(_under("decoder", dec))
    return out


def _ln(p, x):
    return layernorm(x, p["scale"], p["bias"])


def encode(params: dict, cfg: dict, frames, num: Numerics):
    w = params["src_proj"]["w"]
    x = num.mm(frames.to(w.dtype), w)
    for i in range(cfg["encdec"]["num_encoder_layers"]):
        p = _index(params["encoder"], i)
        x = x + self_attention(num, p["attn"], _ln(p["ln1"], x), cfg,
                               causal=False, rope_theta=cfg["rope_theta"])
        x = x + gated_mlp(num, p["mlp"], _ln(p["ln2"], x), cfg["act"])
    return _ln(params["enc_norm"], x)


def forward(params: dict, cfg: dict, batch: dict, num: Numerics):
    """The decoder's final hidden states (B,S,D) and a zero auxiliary
    loss."""
    memory = encode(params, cfg, batch["source_embeds"], num)
    x = params["embed"]["table"][batch["tokens"].long()]
    for i in range(cfg["num_layers"]):
        p = _index(params["decoder"], i)
        x = x + self_attention(num, p["self"], _ln(p["ln1"], x), cfg,
                               causal=True, rope_theta=cfg["rope_theta"])
        x = x + self_attention(num, p["cross"], _ln(p["lnx"], x), cfg,
                               causal=False, rope_theta=0.0, memory=memory)
        x = x + gated_mlp(num, p["mlp"], _ln(p["ln2"], x), cfg["act"])
    return _ln(params["final_norm"], x), torch.zeros((), device=x.device)


def loss(params: dict, cfg: dict, batch: dict, num: Numerics):
    hidden, _ = forward(params, cfg, batch, num)
    return lm_loss(num, params["lm_head"]["w"], hidden, batch["labels"])
