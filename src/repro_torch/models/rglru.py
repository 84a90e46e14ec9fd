"""RecurrentGemma / Griffin RG-LRU recurrent block (arXiv:2402.19427;
``repro.models.rglru``).

The full-sequence forward runs the diagonal linear recurrence
h_t = a_t * h_{t-1} + b_t (log-space gates) over the whole sequence.  With
``impl="auto"`` it goes through ``hopper.rglru_scan.ops.rglru_scan`` from
h0 = 0: kernel K4 on a CUDA tensor, its plain sequential version on a CPU
tensor; with ``impl="dense"`` (the attention's name for its plain path) it
runs the model's parallel form ``rglru_scan_assoc``.  Both plain forms
live beside the kernel in ``hopper/rglru_scan/ref.py``.  Decode is the
O(1) step.

Decode caches are updated **in place** (``copy_``): the port's
``decode_step`` keeps no returned cache, and the scanned stages hand each
layer views into stacked cache tensors.  The cache keeps the reference's
layout, ``{"conv": (B,K-1,W), "h": (B,W)}``, both float32.

Numerics follow the reference: the gates are float32 products against
float32 copies of the gate weights; ``jax.nn.softplus`` is
``logaddexp(x, 0)`` (``torch.logaddexp``, not ``F.softplus``, which
switches to x above 20); ``jax.nn.gelu`` is the tanh form; h returns to
x's dtype before the gate product.

Under tensor parallelism (``par``) the width splits over the "model" dim:
``in_x``, ``in_gate``, ``conv``, the gate biases, ``lam`` and ``out``'s
rows by width, ``w_a`` and ``w_x`` by rows only.  A rank's block of u
against its rows of ``w_a`` / ``w_x`` is a partial sum of the whole gate
input: the sums are reduce-scattered to the rank's width
(``tensor_parallel.reduce_scatter_to_tp``, whose gradient gathers them
back), K4 runs on that width, and ``out``'s partial product is summed.
Decode reads and writes the whole state (the step gathers a split one),
the rank's width of it computed here and gathered whole.
"""

from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.hopper.rglru_scan.ops import rglru_scan
from repro_torch.hopper.rglru_scan.ref import rglru_scan_assoc
from repro_torch.models.init_utils import (dense, dense_axes,
                                           truncated_normal)
from repro_torch.models.layers import activation
from repro_torch.models.xlstm import causal_conv1d
from repro_torch.sharding import tensor_parallel as tpm

_C = 8.0  # the paper's fixed scalar c in a_t = exp(-c * softplus(Lambda) * r_t)


def _width(cfg: ModelConfig) -> int:
    return cfg.rglru.lru_width or cfg.d_model


def rglru_init(gen: torch.Generator, cfg: ModelConfig, dtype=None) -> dict:
    dtype = dtype or getattr(torch, cfg.dtype)
    g = cfg.rglru
    w = _width(cfg)
    # Lambda init so that a^c spans (0.9, 0.999) roughly: the standard LRU
    # init, softplus^-1(-log(u) / c)
    u = torch.empty(w, dtype=torch.float32, device=gen.device).uniform_(
        0.9, 0.999, generator=gen)
    lam = torch.log(torch.expm1(-torch.log(u) / _C))
    f32 = dict(dtype=torch.float32, device=gen.device)
    return {
        "in_x": dense(gen, cfg.d_model, w, dtype=dtype),
        "in_gate": dense(gen, cfg.d_model, w, dtype=dtype),
        "conv": truncated_normal(gen, (g.conv_kernel, w),
                                 1.0 / math.sqrt(g.conv_kernel), dtype),
        "w_a": dense(gen, w, w, dtype=dtype, scale=1.0 / math.sqrt(w)),
        "w_x": dense(gen, w, w, dtype=dtype, scale=1.0 / math.sqrt(w)),
        "b_a": torch.zeros(w, **f32),
        "b_x": torch.zeros(w, **f32),
        "lam": lam,
        "out": dense(gen, w, cfg.d_model, dtype=dtype),
    }


def rglru_axes(cfg: ModelConfig) -> dict:
    return {"in_x": dense_axes(("embed", "lru")),
            "in_gate": dense_axes(("embed", "lru")),
            "conv": ("conv", "lru"),
            "w_a": dense_axes(("lru", "lru")),
            "w_x": dense_axes(("lru", "lru")),
            "b_a": ("lru",),
            "b_x": ("lru",),
            "lam": ("lru",),
            "out": dense_axes(("lru", "embed"))}


def _softplus(x):
    """``jax.nn.softplus``: log(1 + e^x) as logaddexp(x, 0), exact at
    every x (``F.softplus`` returns x itself above its threshold of 20)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _gates(p, u, par=None):
    """log_a (B,S,W) and the gated input b_t of the recurrence, float32.
    With ``par`` u is this rank's width block and ``w_a`` / ``w_x`` its
    rows: the products are summed over the "model" dim down to its
    width."""
    uf = u.to(torch.float32)
    ga = uf @ p["w_a"]["w"].to(torch.float32)
    gx = uf @ p["w_x"]["w"].to(torch.float32)
    if par is not None:
        ga, gx = tpm.reduce_scatter_to_tp(torch.stack([ga, gx]), par
                                          ).unbind(0)
    r = torch.sigmoid(ga + p["b_a"])
    i = torch.sigmoid(gx + p["b_x"])
    log_a = -_C * _softplus(p["lam"]) * r                  # (B,S,W), <= 0
    a2 = torch.exp(2.0 * log_a)
    b = torch.sqrt(torch.clamp(1.0 - a2, min=1e-9)) * (i * uf)
    return log_a, b


def rglru_block_apply(p, cfg: ModelConfig, x, *, cache=None, index=None,
                      impl: str = "auto", par=None):
    """Full recurrent sublayer: proj -> conv -> RG-LRU -> gated out proj.
    x: (B,S,D).

    cache: None (a full-sequence forward, through K4 with
    ``impl="auto"``) or the layer's decode cache, written in place (one
    token).  Returns (out, cache).  ``par``: this rank's width (module
    docstring)."""
    if impl not in ("auto", "dense"):
        raise ValueError(f"unknown RG-LRU impl {impl!r}; use 'auto' (the "
                         f"kernel on the card) or 'dense'")
    wl = p["in_x"]["w"].shape[1]
    tp = par if par is not None and par.tp and wl < _width(cfg) else None
    cols = slice(tp.tp_rank * wl, (tp.tp_rank + 1) * wl) if tp else \
        slice(None)
    x = tpm.copy_to_tp(x, tp)
    xb = x @ p["in_x"]["w"]
    gate = activation("gelu")(x @ p["in_gate"]["w"])      # the tanh form
    conv_state = cache["conv"][..., cols] if cache is not None else None
    u, conv_state = causal_conv1d(xb, p["conv"], conv_state)
    log_a, b = _gates(p, u, tp)
    if cache is not None:
        h = torch.exp(log_a[:, 0]) * cache["h"][:, cols] + b[:, 0]
        if tp is not None:          # the whole state from the ranks' widths
            conv_state = tpm.all_gather_dim(conv_state, tp.tp_group, -1)
            h_all = tpm.all_gather_dim(h, tp.tp_group, -1)
        else:
            h_all = h
        cache["conv"].copy_(conv_state)
        cache["h"].copy_(h_all)
        h = h[:, None]
    elif impl == "auto":
        h = rglru_scan(log_a, b, log_a.new_zeros((x.shape[0], wl)))
    else:
        h = rglru_scan_assoc(log_a, b)
    return tpm.reduce_from_tp((h.to(x.dtype) * gate) @ p["out"]["w"],
                              tp), cache


def init_rglru_cache(cfg: ModelConfig, batch: int, device="cpu") -> dict:
    w = _width(cfg)
    f32 = dict(dtype=torch.float32, device=device)
    return {"conv": torch.zeros((batch, cfg.rglru.conv_kernel - 1, w), **f32),
            "h": torch.zeros((batch, w), **f32)}
