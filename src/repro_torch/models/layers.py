"""Shared layer math: norms, activations, RoPE (with Qwen2-VL's M-RoPE),
the gated MLP (``repro.models.layers``).

Where the numbers could drift from the reference: ``jax.nn.gelu`` is the
tanh approximation by default, so ``gelu`` here is too; RMSNorm takes a
plain ``scale`` (not gemma's ``1 + scale``); norms and RoPE compute in
float32 and cast back to the input's dtype.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.init_utils import dense
from repro_torch.sharding.tensor_parallel import copy_to_tp, reduce_from_tp


# ---------------------------------------------------------------- norms ----
def apply_norm(p, x, kind: str, eps: float = 1e-6):
    xf = x.to(torch.float32)
    if kind == "rmsnorm":
        var = xf.square().mean(dim=-1, keepdim=True)
        y = xf * torch.rsqrt(var + eps) * p["scale"].to(torch.float32)
        return y.to(x.dtype)
    if kind == "layernorm":
        mu = xf.mean(dim=-1, keepdim=True)
        var = xf.var(dim=-1, keepdim=True, unbiased=False)
        y = (xf - mu) * torch.rsqrt(var + eps)
        y = y * p["scale"].to(torch.float32) + p["bias"].to(torch.float32)
        return y.to(x.dtype)
    raise ValueError(kind)


def _gelu_tanh(x):
    return F.gelu(x, approximate="tanh")


def activation(name: str):
    if name == "silu":
        return F.silu
    if name == "gelu":
        return _gelu_tanh
    raise ValueError(name)


def activation_backward(name: str):
    """``(grad, x) -> grad * act'(x)`` for :func:`activation` ``name``:
    the op autograd itself runs in its backward."""
    if name == "silu":
        return torch.ops.aten.silu_backward
    if name == "gelu":
        return lambda grad, x: torch.ops.aten.gelu_backward(
            grad, x, approximate="tanh")
    raise ValueError(name)


def softcap(x, cap: float):
    if not cap:
        return x
    return torch.tanh(x / cap) * cap


# ----------------------------------------------------------------- RoPE ----
def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    half = head_dim // 2
    # theta stays a Python scalar (cast to float32 inside the kernel): a
    # tensor made from it on the card would be a blocking host-to-device
    # copy in every layer of every decode step
    return theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=device) / half)


def apply_rope(x, positions, theta: float):
    """x: (..., seq, heads, head_dim); positions: broadcastable to
    (..., seq)."""
    half = x.shape[-1] // 2
    freqs = rope_freqs(x.shape[-1], theta, x.device)        # (half,)
    ang = positions[..., None].to(torch.float32) * freqs  # (..., seq, half)
    cos = torch.cos(ang)[..., None, :]                  # (..., seq, 1, half)
    sin = torch.sin(ang)[..., None, :]
    x1 = x[..., :half].to(torch.float32)
    x2 = x[..., half:].to(torch.float32)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_mrope(x, positions3, theta: float, sections: tuple[int, int, int]):
    """Qwen2-VL multimodal RoPE [arXiv:2409.12191].

    x: (..., seq, heads, head_dim); positions3: (..., seq, 3) integer
    (temporal, height, width) position ids.  The head_dim/2 rotary
    frequencies are split into ``sections`` (t/h/w); each section rotates
    by its own position stream.  With the three streams equal this is
    ``apply_rope``."""
    half = x.shape[-1] // 2
    assert sum(sections) == half, (sections, half)
    freqs = rope_freqs(x.shape[-1], theta, x.device)        # (half,)
    # the position stream (0, 1 or 2) that drives each frequency
    sec_id = torch.cat([torch.full((s,), i, dtype=torch.long,
                                   device=x.device)
                        for i, s in enumerate(sections)])
    pos = positions3.to(torch.float32)[..., sec_id]         # (..., seq, half)
    ang = pos * freqs
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1 = x[..., :half].to(torch.float32)
    x2 = x[..., half:].to(torch.float32)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ------------------------------------------------------------ gated MLP ----
def mlp_init(gen: torch.Generator, cfg: ModelConfig, d_ff: int | None = None,
             dtype=None) -> dict:
    d_ff = d_ff or cfg.d_ff
    dtype = dtype or getattr(torch, cfg.dtype)
    return {
        "gate": dense(gen, cfg.d_model, d_ff, dtype=dtype),
        "up": dense(gen, cfg.d_model, d_ff, dtype=dtype),
        "down": dense(gen, d_ff, cfg.d_model, dtype=dtype),
    }


def mlp_axes() -> dict:
    from repro_torch.models.init_utils import dense_axes
    return {"gate": dense_axes(("embed", "mlp")),
            "up": dense_axes(("embed", "mlp")),
            "down": dense_axes(("mlp", "embed"))}


def mlp_apply(p, x, act_name: str, *, par=None, d_ff: int | None = None):
    """The gated MLP.  Under tensor parallelism (``par``) with ``gate`` /
    ``up`` holding this rank's columns of the ``d_ff`` width (narrower
    than ``d_ff``), the input takes the gradient's sum over the "model"
    dim and ``down``'s partial product is summed over it; a width that
    does not divide the dim is held whole and computed whole."""
    act = activation(act_name)
    split = par is not None and par.tp and p["gate"]["w"].shape[1] < d_ff
    if split:
        x = copy_to_tp(x, par)
    h = act(x @ p["gate"]["w"]) * (x @ p["up"]["w"])
    if split:
        return reduce_from_tp(h @ p["down"]["w"], par)
    return h @ p["down"]["w"]
