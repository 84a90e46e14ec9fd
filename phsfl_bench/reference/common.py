"""Plain PyTorch building blocks of the benchmark's references.

Written from the configurations' published descriptions, not from the
program: no module of the port is imported here.  Storage follows the
configuration's stated precision (``dtype``, bfloat16 for both models):
every matrix product takes operands in that dtype and returns it (the
tensor cores accumulate in float32); norms, RoPE, softmax, the router
and the loss compute in float32 and cast back.  Each product goes
through :class:`Numerics`, whose ``fp8`` switch rounds both operands to
float8 e4m3 (per-tensor scale) first: the lower-precision control.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

F32 = torch.float32
E4M3_MAX = 448.0


class Numerics:
    """How the reference multiplies: ``fp8`` rounds each operand of a
    matrix product to float8 e4m3 under a per-tensor scale (the control,
    the precision below bfloat16)."""

    def __init__(self, fp8: bool = False):
        self.fp8 = fp8

    def _round(self, t: torch.Tensor) -> torch.Tensor:
        if not self.fp8:
            return t
        scale = t.detach().abs().amax().to(F32).clamp_min(1e-30) / E4M3_MAX
        q = (t.to(F32) / scale).to(torch.float8_e4m3fn).to(F32) * scale
        # straight-through: the control keeps the bfloat16 gradient path
        return t + (q.to(t.dtype) - t).detach()

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self._round(a) @ self._round(b)


def rmsnorm(x, scale, eps: float = 1e-6):
    xf = x.to(F32)
    y = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
    return (y * scale.to(F32)).to(x.dtype)


def layernorm(x, scale, bias, eps: float = 1e-6):
    xf = x.to(F32)
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * scale.to(F32) + bias.to(F32)).to(x.dtype)


def act(name: str):
    if name == "silu":
        return F.silu
    if name == "gelu":                          # the tanh approximation
        return lambda t: F.gelu(t, approximate="tanh")
    raise ValueError(name)


def rope(x, theta: float):
    """Rotary embedding over the last dim of x (B,S,H,hd), rotating the
    first half against the second, at positions 0..S-1, in float32."""
    s, hd = x.shape[1], x.shape[-1]
    half = hd // 2
    inv = theta ** (-torch.arange(half, dtype=F32, device=x.device) / half)
    ang = torch.arange(s, dtype=F32, device=x.device)[:, None] * inv
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    a, b = x[..., :half].to(F32), x[..., half:].to(F32)
    return torch.cat([a * cos - b * sin, b * cos + a * sin], -1).to(x.dtype)


def attention(q, k, v, causal: bool):
    """Softmax attention in float32, q (B,Sq,H,hd), k/v (B,Sk,KV,hd),
    grouped query heads sharing a kv head.  Returns (B,Sq,H,hd) in q's
    dtype."""
    b, sq, h, hd = q.shape
    kvh = k.shape[2]
    qg = q.to(F32).reshape(b, sq, kvh, h // kvh, hd).permute(0, 2, 3, 1, 4)
    kf = k.to(F32).permute(0, 2, 1, 3)[:, :, None]           # (B,KV,1,Sk,hd)
    vf = v.to(F32).permute(0, 2, 1, 3)[:, :, None]
    logits = (qg / math.sqrt(hd)) @ kf.transpose(-1, -2)     # (B,KV,G,Sq,Sk)
    if causal:
        sk = k.shape[1]
        keep = torch.ones(sq, sk, dtype=torch.bool, device=q.device).tril()
        logits = logits.masked_fill(~keep, float("-inf"))
    out = torch.softmax(logits, -1) @ vf                     # (B,KV,G,Sq,hd)
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, hd).to(q.dtype)


def project(num: Numerics, x, p: dict, heads: int, hd: int):
    """x (B,S,D) through a (D, heads, hd) projection, with its bias."""
    w = p["w"]
    t = num.mm(x, w.reshape(w.shape[0], heads * hd))
    t = t.reshape(*x.shape[:-1], heads, hd)
    if "b" in p:
        t = t + p["b"]
    return t


def self_attention(num: Numerics, p: dict, x, cfg: dict, *, causal: bool,
                   rope_theta: float, memory=None):
    """Attention sublayer: q from x; k, v from x, or from ``memory``
    (cross-attention, keys unrotated); qk-norm and RoPE as the config
    says; the output projection."""
    h, kvh, hd = cfg["num_heads"], cfg["num_kv_heads"], cfg["head_dim"]
    src = x if memory is None else memory
    q = project(num, x, p["q"], h, hd)
    k = project(num, src, p["k"], kvh, hd)
    v = project(num, src, p["v"], kvh, hd)
    if cfg.get("qk_norm"):
        q = rmsnorm(q, p["q_norm"]["scale"])
        k = rmsnorm(k, p["k_norm"]["scale"])
    if rope_theta and memory is None:
        q, k = rope(q, rope_theta), rope(k, rope_theta)
    o = attention(q, k, v, causal)
    return num.mm(o.reshape(*x.shape[:-1], h * hd), p["o"]["w"])


def gated_mlp(num: Numerics, p: dict, x, act_name: str):
    f = act(act_name)
    return num.mm(f(num.mm(x, p["gate"]["w"])) * num.mm(x, p["up"]["w"]),
                  p["down"]["w"])


def lm_loss(num: Numerics, w_head, hidden, labels):
    """Mean token cross-entropy of the logits ``hidden @ w_head`` (the
    product in the storage dtype, the softmax in float32)."""
    logits = num.mm(hidden, w_head).to(F32)
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           labels.reshape(-1).long())


def paths(tree: dict, prefix: str = ""):
    """(path, tensor) of every leaf, dict keys in sorted order."""
    for k in sorted(tree):
        v = tree[k]
        p = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            yield from paths(v, p)
        else:
            yield p, v


def nest(flat: dict) -> dict:
    """A nested dict from {"a/b/c": value}."""
    out: dict = {}
    for path, v in flat.items():
        cur = out
        keys = path.split("/")
        for k in keys[:-1]:
            cur = cur.setdefault(k, {})
        cur[keys[-1]] = v
    return out
