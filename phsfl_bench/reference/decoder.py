"""Plain reference of a decoder LM with attention layers and a gated MLP
or a token-choice mixture of experts (OLMoE, arXiv:2409.02060): the
parameter layout, the forward pass to the final hidden states, and the
training loss.  Nothing of the port is imported.

Layer i: x += attn(rmsnorm(x)); x += ffn(rmsnorm(x)).  Attention has
qk-norm where the config says (an RMSNorm over each head's q and k),
RoPE on q and k, causal softmax.  The MoE routes each token by a float32
softmax router to its top-k experts, weights renormalised to sum to 1,
and adds the Switch load-balancing loss E * sum_e(f_e * P_e) times
``router_aux_loss`` to the cross-entropy, summed over the MoE layers.

The layout is the configuration's: the first ``n_client_layers`` layers
(the PHSFL client side) each under ``stage0/b<i>``, the rest stacked on a
leading dim under ``stage1/b0``; ``embed``, ``final_norm`` and the frozen
``lm_head`` beside them.
"""

from __future__ import annotations

import math

import torch

from phsfl_bench.reference.common import (F32, Numerics, act, gated_mlp,
                                          lm_loss, rmsnorm, self_attention)


def padded_vocab(cfg: dict) -> int:
    return -(-cfg["vocab_size"] // 256) * 256


def _layer_layout(cfg: dict, dtype) -> dict:
    d, h, kvh, hd = (cfg["d_model"], cfg["num_heads"], cfg["num_kv_heads"],
                     cfg["head_dim"])
    lay = {"ln1/scale": ((d,), dtype, "ones"),
           "ln2/scale": ((d,), dtype, "ones"),
           "attn/q/w": ((d, h, hd), dtype, 1 / math.sqrt(d)),
           "attn/k/w": ((d, kvh, hd), dtype, 1 / math.sqrt(d)),
           "attn/v/w": ((d, kvh, hd), dtype, 1 / math.sqrt(d)),
           "attn/o/w": ((h * hd, d), dtype, 1 / math.sqrt(h * hd))}
    if cfg.get("qk_norm"):
        lay["attn/q_norm/scale"] = ((hd,), dtype, "ones")
        lay["attn/k_norm/scale"] = ((hd,), dtype, "ones")
    moe = cfg.get("moe")
    if moe:
        e, f = moe["num_experts"], moe["d_ff_expert"]
        lay["moe/router/w"] = ((d, e), F32, 1 / math.sqrt(d))
        lay["moe/w_gate"] = ((e, d, f), dtype, 1 / math.sqrt(d))
        lay["moe/w_up"] = ((e, d, f), dtype, 1 / math.sqrt(d))
        lay["moe/w_down"] = ((e, f, d), dtype, 1 / math.sqrt(f))
    else:
        f = cfg["d_ff"]
        lay["mlp/gate/w"] = ((d, f), dtype, 1 / math.sqrt(d))
        lay["mlp/up/w"] = ((d, f), dtype, 1 / math.sqrt(d))
        lay["mlp/down/w"] = ((f, d), dtype, 1 / math.sqrt(f))
    return lay


def _lead(cfg: dict) -> int:
    if len(cfg["block_pattern"]) != 1 or cfg.get("moe", {}).get(
            "first_dense_layers", 0):
        raise ValueError("this reference takes one layer kind throughout")
    return min(cfg["n_client_layers"], cfg["num_layers"])


def layout(cfg: dict) -> dict:
    """{path: (shape, dtype, init)}: init is a std for a normal draw
    (clipped to 2 std), or "ones" / "zeros"."""
    dtype = getattr(torch, cfg["dtype"])
    d, v = cfg["d_model"], padded_vocab(cfg)
    out = {"embed/table": ((v, d), dtype, 1.0),
           "final_norm/scale": ((d,), dtype, "ones"),
           "lm_head/w": ((d, v), dtype, 1 / math.sqrt(d))}
    lead, lay = _lead(cfg), _layer_layout(cfg, dtype)
    for i in range(lead):
        out.update({f"stage0/b{i}/{k}": s for k, s in lay.items()})
    rest = cfg["num_layers"] - lead
    if rest:
        out.update({f"stage{1 if lead else 0}/b0/{k}": ((rest, *sh), dt, ini)
                    for k, (sh, dt, ini) in lay.items()})
    return out


def layers(params: dict, cfg: dict):
    """Each layer's parameters, in order."""
    lead = _lead(cfg)
    for i in range(lead):
        yield params["stage0"][f"b{i}"]
    stacked = params.get(f"stage{1 if lead else 0}", {}).get("b0")
    for r in range(cfg["num_layers"] - lead):
        yield _index(stacked, r)


def _index(tree, r):
    if isinstance(tree, dict):
        return {k: _index(v, r) for k, v in tree.items()}
    return tree[r]


def moe(num: Numerics, p: dict, x, cfg: dict):
    """Top-k mixture of experts on x (B,S,D): (output in x's dtype, the
    Switch auxiliary loss in float32)."""
    m = cfg["moe"]
    e_n, k = m["num_experts"], m["top_k"]
    flat = x.reshape(-1, x.shape[-1])
    n = flat.shape[0]
    probs = torch.softmax(flat.to(F32) @ p["router"]["w"], -1)
    top_w, top_e = torch.topk(probs, k, -1)
    top_w = top_w / top_w.sum(-1, keepdim=True).clamp_min(1e-9)
    counts = torch.bincount(top_e.reshape(-1), minlength=e_n).to(F32)
    aux = e_n * (counts / (n * k) * probs.mean(0)).sum()
    f = act(cfg["act"])
    out = torch.zeros(flat.shape, dtype=F32, device=x.device)
    for e in range(e_n):
        tok, slot = (top_e == e).nonzero(as_tuple=True)
        if tok.numel() == 0:
            continue
        xe = flat[tok]
        ye = num.mm(f(num.mm(xe, p["w_gate"][e])) * num.mm(xe, p["w_up"][e]),
                    p["w_down"][e])
        out = out.index_add(0, tok, ye.to(F32) * top_w[tok, slot, None])
    return out.to(x.dtype).reshape(x.shape), aux


def forward(params: dict, cfg: dict, batch: dict, num: Numerics):
    """Final hidden states (B,S,D) of ``batch["tokens"]`` and the summed
    MoE auxiliary loss."""
    x = params["embed"]["table"][batch["tokens"].long()]
    aux = torch.zeros((), dtype=F32, device=x.device)
    for p in layers(params, cfg):
        x = x + self_attention(num, p["attn"], rmsnorm(x, p["ln1"]["scale"]),
                               cfg, causal=True, rope_theta=cfg["rope_theta"])
        h = rmsnorm(x, p["ln2"]["scale"])
        if "moe" in p:
            y, a = moe(num, p["moe"], h, cfg)
            aux = aux + a
        else:
            y = gated_mlp(num, p["mlp"], h, cfg["act"])
        x = x + y
    return rmsnorm(x, params["final_norm"]["scale"]), aux


def loss(params: dict, cfg: dict, batch: dict, num: Numerics):
    hidden, aux = forward(params, cfg, batch, num)
    ce = lm_loss(num, params["lm_head"]["w"], hidden, batch["labels"])
    if cfg.get("moe"):
        ce = ce + cfg["moe"]["router_aux_loss"] * aux
    return ce
