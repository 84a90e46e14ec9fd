"""xLSTM blocks (arXiv:2405.04517; ``repro.models.xlstm``): mLSTM (matrix
memory, parallelizable) and sLSTM (scalar memory with a true
hidden-to-hidden recurrence).

The mLSTM full-sequence forward is the chunkwise-parallel form.  With
``impl="auto"`` it goes through ``hopper.mlstm_chunk.ops.mlstm_chunk``:
kernel K3 on a CUDA tensor, its plain version on a CPU tensor; with
``impl="dense"`` (the attention's name for its plain path) it runs the
plain ``mlstm_chunkwise`` at the model's chunk.  Decode uses the O(1)
recurrent step ``mlstm_step``; both plain forms live beside the kernel in
``hopper/mlstm_chunk/ref.py`` and are re-exported here.  The sLSTM is
sequential by nature: the reference's ``lax.scan`` over time is a Python
loop over time here (the JAX package has no kernel for it).

Decode caches are updated **in place** (``copy_`` and in-place products):
the port's ``decode_step`` keeps no returned cache, and the scanned
stages hand each layer views into stacked cache tensors.  The caches keep
the reference's layout: ``{"conv", "carry": (C, n, m)}`` for the mLSTM,
``{"state": (c, n, h, m)}`` for the sLSTM, all float32.

Casts follow the reference: k is divided by sqrt(dh) in the model dtype;
the gates come from the float32 ``conv_act`` against float32 gate
weights; h returns in q's dtype before the per-head RMSNorm; the sLSTM
cell computes in float32.

Under tensor parallelism (``par``) the blocks keep the reference's
layout and move data inside the layer:

- mLSTM: ``up`` packs ``[x_m ; z]`` into one matrix whose contiguous
  column block is not a rank's (x_m, z) pair, so its output is gathered
  over the "model" dim and each rank takes its block of x_m and of z
  (``conv``'s and ``down``'s block).  ``q``, ``k``, ``v`` and the gates
  split by rows only: a rank's products are partial sums.  When the heads
  divide the dim they are reduce-scattered to the rank's heads and K3
  runs on those (the per-head norm's scale takes the gradient's sum);
  otherwise they are summed whole, every rank runs every head, and keeps
  its block of h.
- sLSTM: ``w``'s column block is whole heads of the head-major [i f z o]
  gates when the heads divide the dim; a rank then runs the recurrence on
  its heads (its rows of ``r`` and ``b``) and the hidden states are
  gathered.  Otherwise its block is part of a head's gates: W x is
  gathered and every rank runs every head.  The MLP is column- and
  row-parallel where its width divides.

Decode reads and writes whole states (the step gathers a split one); a
rank computes its heads' part and gathers it whole.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.hopper.mlstm_chunk.ops import mlstm_chunk
from repro_torch.hopper.mlstm_chunk.ref import (  # noqa: F401 (re-exported)
    MLSTM_CHUNK, NEG_BIG, mlstm_chunkwise, mlstm_step)
from repro_torch.models.init_utils import (dense, dense_axes, norm,
                                           norm_axes, truncated_normal)
from repro_torch.models.layers import activation, apply_norm
from repro_torch.sharding import tensor_parallel as tpm


# =============================================================== mLSTM ======
def mlstm_init(gen: torch.Generator, cfg: ModelConfig, dtype=None) -> dict:
    dtype = dtype or getattr(torch, cfg.dtype)
    x = cfg.xlstm
    d = cfg.d_model
    di = int(d * x.proj_factor_mlstm)
    h = x.num_heads
    dh = di // h
    return {
        "up": dense(gen, d, 2 * di, dtype=dtype),          # [x_m ; z-gate]
        "conv": truncated_normal(gen, (x.conv_kernel, di),
                                 1.0 / math.sqrt(x.conv_kernel), dtype),
        "q": dense(gen, di, di, dtype=dtype),
        "k": dense(gen, di, di, dtype=dtype),
        "v": dense(gen, di, di, dtype=dtype),
        "i_gate": dense(gen, di, h, dtype=torch.float32),
        "f_gate": dense(gen, di, h, dtype=torch.float32),
        "out_norm": norm(dh, "rmsnorm", dtype, gen.device),  # per-head norm
        "down": dense(gen, di, d, dtype=dtype),
    }


def mlstm_axes(cfg: ModelConfig) -> dict:
    return {"up": dense_axes(("embed", "mlp")),
            "conv": ("conv", "mlp"),
            "q": dense_axes(("mlp", "mlp")),
            "k": dense_axes(("mlp", "mlp")),
            "v": dense_axes(("mlp", "mlp")),
            "i_gate": dense_axes(("mlp", None)),
            "f_gate": dense_axes(("mlp", None)),
            "out_norm": norm_axes("rmsnorm"),
            "down": dense_axes(("mlp", "embed"))}


def causal_conv1d(x, w, state=None):
    """Depthwise causal conv.  x: (B,S,C); w: (K,C).

    state: (B,K-1,C) trailing context from previous tokens (decode).
    Returns (y, new_state)."""
    k = w.shape[0]
    if state is None:
        pad = x.new_zeros((x.shape[0], k - 1, *x.shape[2:]))
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)                        # (B, S+K-1, C)
    y = sum(xp[:, i:i + x.shape[1]] * w[i] for i in range(k))
    new_state = xp[:, -(k - 1):] if k > 1 else state
    return y, new_state


def _mlstm_heads(p, cfg: ModelConfig, x_m, conv_state=None):
    """Project the mLSTM branch to per-head q, k, v and scalar gates."""
    h = cfg.xlstm.num_heads
    conv_out, conv_state = causal_conv1d(x_m, p["conv"], conv_state)
    conv_act = F.silu(conv_out)
    b, s, di = x_m.shape
    dh = di // h
    q = (conv_act @ p["q"]["w"]).reshape(b, s, h, dh)
    # sqrt(dh) as a Python scalar: the division rounds in the model dtype
    k = (conv_act @ p["k"]["w"]).reshape(b, s, h, dh) / math.sqrt(dh)
    v = (x_m @ p["v"]["w"]).reshape(b, s, h, dh)
    act32 = conv_act.to(torch.float32)
    li = act32 @ p["i_gate"]["w"]                          # (B,S,H)
    lf = F.logsigmoid(act32 @ p["f_gate"]["w"])
    return q, k, v, li, lf, conv_state


def mlstm_block_apply(p, cfg: ModelConfig, x, *, cache=None, index=None,
                      impl: str = "auto", par=None):
    """Full mLSTM residual block.  x: (B,S,D).

    cache: None (a full-sequence forward: the chunkwise form, through K3
    with ``impl="auto"``) or the layer's decode cache, written in place.
    Returns (out, cache).  ``par``: this rank's block (module
    docstring)."""
    if impl not in ("auto", "dense"):
        raise ValueError(f"unknown mLSTM impl {impl!r}; use 'auto' (the "
                         f"kernel on the card) or 'dense'")
    di = int(cfg.d_model * cfg.xlstm.proj_factor_mlstm)
    if par is not None and par.tp and p["conv"].shape[-1] < di:
        return _mlstm_block_tp(p, cfg, x, cache, impl, par)
    up = x @ p["up"]["w"]
    x_m, z = up[..., :di], up[..., di:]
    conv_state = cache["conv"] if cache is not None else None
    q, k, v, li, lf, conv_state = _mlstm_heads(p, cfg, x_m, conv_state)
    h = _mlstm_core(q, k, v, li, lf, cache, impl)
    if cache is not None:
        cache["conv"].copy_(conv_state)
    h = apply_norm(p["out_norm"], h, "rmsnorm")            # per-head norm
    b, s = x.shape[:2]
    h = h.reshape(b, s, di)
    return (h * F.silu(z)) @ p["down"]["w"], cache


def _mlstm_core(q, k, v, li, lf, cache, impl: str, heads=slice(None)):
    """The cell over q/k/v (B,S,h,dh): the decode step on the carry's
    ``heads`` (in place), or the chunkwise form."""
    if cache is not None:
        h, _ = mlstm_step(q, k, v, li, lf,
                          tuple(t[:, heads] for t in cache["carry"]))
        return h
    if impl == "auto":
        return mlstm_chunk(q, k, v, li, lf)
    return mlstm_chunkwise(q, k, v, li, lf)[0]


def _mlstm_block_tp(p, cfg: ModelConfig, x, cache, impl: str, par):
    """The mLSTM block on this rank's block of di (module docstring)."""
    nh = cfg.xlstm.num_heads
    di = int(cfg.d_model * cfg.xlstm.proj_factor_mlstm)
    dh = di // nh
    dl = p["conv"].shape[-1]
    r = par.tp_rank
    mine = slice(r * dl, (r + 1) * dl)
    b, s = x.shape[:2]
    x = tpm.copy_to_tp(x, par)
    up = tpm.gather_from_tp(x @ p["up"]["w"], par)         # (B,S,2di)
    x_m, z = up[..., mine], up[..., di + r * dl:di + (r + 1) * dl]
    conv_state = cache["conv"][..., mine] if cache is not None else None
    conv_out, conv_state = causal_conv1d(x_m, p["conv"], conv_state)
    conv_act = F.silu(conv_out)
    # partial sums over the rank's rows of q, k, v and the gates
    qkv = torch.stack([conv_act @ p["q"]["w"], conv_act @ p["k"]["w"],
                       x_m @ p["v"]["w"]])                 # (3,B,S,di)
    act32 = conv_act.to(torch.float32)
    gates = torch.stack([act32 @ p["i_gate"]["w"],
                         act32 @ p["f_gate"]["w"]])        # (2,B,S,H)
    if nh % par.tp_size == 0:       # whole heads a rank: its heads alone
        hl = nh // par.tp_size
        heads = slice(r * hl, (r + 1) * hl)
        qkv = tpm.reduce_scatter_to_tp(qkv, par)
        gates = tpm.reduce_scatter_to_tp(gates, par)
        norm = {"scale": tpm.copy_to_tp(p["out_norm"]["scale"], par)}
    else:                           # every head on every rank
        hl, heads = nh, slice(None)
        qkv = tpm.reduce_from_tp(qkv, par)
        gates = tpm.reduce_from_tp(gates, par)
        norm = p["out_norm"]
    q, k, v = (t.reshape(b, s, hl, dh) for t in qkv.unbind(0))
    # sqrt(dh) as a Python scalar: the division rounds in the model dtype
    k = k / math.sqrt(dh)
    li, lf = gates[0], F.logsigmoid(gates[1])
    h = _mlstm_core(q, k, v, li, lf, cache, impl, heads)
    h = apply_norm(norm, h, "rmsnorm").reshape(b, s, hl * dh)
    if hl == nh:
        h = tpm.copy_to_tp(h, par)[..., mine]
    if cache is not None:           # the whole state from the ranks' blocks
        cache["conv"].copy_(tpm.all_gather_dim(conv_state, par.tp_group,
                                               -1))
        if hl < nh:
            for t in cache["carry"]:
                t.copy_(tpm.all_gather_dim(t[:, heads], par.tp_group, 1))
    return tpm.reduce_from_tp((h * F.silu(z)) @ p["down"]["w"], par), cache


def init_mlstm_cache(cfg: ModelConfig, batch: int, device="cpu") -> dict:
    xl = cfg.xlstm
    di = int(cfg.d_model * xl.proj_factor_mlstm)
    h = xl.num_heads
    dh = di // h
    f32 = torch.float32
    return {
        "conv": torch.zeros((batch, xl.conv_kernel - 1, di), dtype=f32,
                            device=device),
        "carry": (torch.zeros((batch, h, dh, dh), dtype=f32, device=device),
                  torch.zeros((batch, h, dh), dtype=f32, device=device),
                  torch.full((batch, h), NEG_BIG, dtype=f32, device=device)),
    }


# =============================================================== sLSTM ======
def slstm_init(gen: torch.Generator, cfg: ModelConfig, dtype=None) -> dict:
    dtype = dtype or getattr(torch, cfg.dtype)
    xl = cfg.xlstm
    d = cfg.d_model
    h = xl.num_heads
    dh = d // h
    dff = int(d * xl.proj_factor_slstm)
    return {
        "w": dense(gen, d, 4 * d, dtype=dtype),            # i,f,z,o all heads
        "r": truncated_normal(gen, (h, dh, 4 * dh), 1.0 / math.sqrt(dh),
                              dtype),
        "b": torch.zeros((4 * d,), dtype=torch.float32, device=gen.device),
        "out_norm": norm(dh, "rmsnorm", dtype, gen.device),
        "up_gate": dense(gen, d, dff, dtype=dtype),
        "up": dense(gen, d, dff, dtype=dtype),
        "down": dense(gen, dff, d, dtype=dtype),
    }


def slstm_axes(cfg: ModelConfig) -> dict:
    return {"w": dense_axes(("embed", "mlp")),
            "r": (None, None, None),      # hidden-to-hidden: replicated
            "b": (None,),
            "out_norm": norm_axes("rmsnorm"),
            "up_gate": dense_axes(("embed", "mlp")),
            "up": dense_axes(("embed", "mlp")),
            "down": dense_axes(("mlp", "embed"))}


def _slstm_cell(r32, wx_t, state):
    """One sLSTM step.  r32: (H,dh,4dh) float32 recurrent weights; wx_t:
    (B,H,4dh) float32, W x_t + b; state: (c, n, h, m), each (B,H,dh)
    float32 (the stabilizer is per unit).  Returns the new state."""
    c, n, hid, m = state
    # (H,B,dh) x (H,dh,4dh): the reference's einsum "bhd,hdk->bhk"
    rh = torch.bmm(hid.transpose(0, 1), r32).transpose(0, 1)
    raw = wx_t + rh
    dh = c.shape[-1]
    i_t, f_t, z_t, o_t = (raw[..., j * dh:(j + 1) * dh] for j in range(4))
    lf = F.logsigmoid(f_t)
    m_new = torch.maximum(lf + m, i_t)
    igate = torch.exp(i_t - m_new)
    fgate = torch.exp(lf + m - m_new)
    c_new = fgate * c + igate * torch.tanh(z_t)
    n_new = fgate * n + igate
    h_new = torch.sigmoid(o_t) * c_new / torch.clamp(n_new, min=1e-6)
    return c_new, n_new, h_new, m_new


def _slstm_loop(r32, wx, state, b: int, s: int, h: int, dh: int,
                device):
    """The recurrence over wx (B,S,h,4dh) float32 from ``state`` (or
    zeros): (h (B,S,h*dh) float32, final state)."""
    if state is None:
        z = lambda: torch.zeros((b, h, dh), dtype=torch.float32,  # noqa: E731
                                device=device)
        state = (z(), z(), z(), torch.full((b, h, dh), NEG_BIG,
                                           dtype=torch.float32,
                                           device=device))
    hs = []
    for t in range(s):
        state = _slstm_cell(r32, wx[:, t], state)
        hs.append(state[2])
    return torch.stack(hs, dim=1).reshape(b, s, h * dh), state


def slstm_scan(p, cfg: ModelConfig, x, state=None):
    """x: (B,S,D) -> (h (B,S,D) in x's dtype, final state).  A Python
    loop over S: the recurrence feeds h back into the gates."""
    b, s, d = x.shape
    h = cfg.xlstm.num_heads
    dh = d // h
    wx = (x @ p["w"]["w"]).to(torch.float32) + p["b"]
    # the reference promotes the bfloat16 r to float32 in the product
    out, state = _slstm_loop(p["r"].to(torch.float32),
                             wx.reshape(b, s, h, 4 * dh), state, b, s, h,
                             dh, x.device)
    return out.to(x.dtype), state


def _slstm_tp(p, cfg: ModelConfig, x, state, par):
    """The sLSTM's recurrence with ``w`` split by columns (module
    docstring): (normed hidden states (B,S,D), the final state of the
    rank's heads, those heads)."""
    b, s, d = x.shape
    nh = cfg.xlstm.num_heads
    dh = d // nh
    x = tpm.copy_to_tp(x, par)
    wx = x @ p["w"]["w"]                                   # (B,S,4d/M)
    if nh % par.tp_size == 0:       # whole heads a rank: its heads alone
        hl = nh // par.tp_size
        heads = slice(par.tp_rank * hl, (par.tp_rank + 1) * hl)
        cols = wx.shape[-1]
        bias = tpm.copy_to_tp(p["b"], par)[par.tp_rank * cols:
                                           (par.tp_rank + 1) * cols]
        r32 = tpm.copy_to_tp(p["r"], par)[heads].to(torch.float32)
        norm = {"scale": tpm.copy_to_tp(p["out_norm"]["scale"], par)}
    else:                           # part of a head's gates: every head
        hl, heads = nh, slice(None)
        wx = tpm.gather_from_tp(wx, par, summed=False)
        bias, r32, norm = p["b"], p["r"].to(torch.float32), p["out_norm"]
    wx = (wx.to(torch.float32) + bias).reshape(b, s, hl, 4 * dh)
    if state is not None:
        state = tuple(t[:, heads] for t in state)
    hid, state = _slstm_loop(r32, wx, state, b, s, hl, dh, x.device)
    hh = apply_norm(norm, hid.to(x.dtype).reshape(b, s, hl, dh),
                    "rmsnorm").reshape(b, s, hl * dh)
    if hl < nh:
        hh = tpm.gather_from_tp(hh, par, summed=False)
    return hh, state, heads


def slstm_block_apply(p, cfg: ModelConfig, x, *, cache=None, index=None,
                      par=None):
    """sLSTM residual block with its post-up-projection MLP.  cache: None
    or the layer's decode cache, whose state is written in place.
    Returns (out, cache).  ``par``: this rank's block (module
    docstring)."""
    b, s, d = x.shape
    tp = par if (par is not None and par.tp
                 and p["w"]["w"].shape[1] < 4 * d) else None
    if tp is None:
        hid, state = slstm_scan(p, cfg, x,
                                None if cache is None else cache["state"])
        if cache is not None:
            for dst, src in zip(cache["state"], state):
                dst.copy_(src)
        hh = apply_norm(p["out_norm"], hid.reshape(
            b, s, cfg.xlstm.num_heads, -1), "rmsnorm").reshape(b, s, d)
    else:
        hh, state, heads = _slstm_tp(p, cfg, x, None if cache is None
                                     else cache["state"], tp)
        if cache is not None:       # the whole state from the ranks' heads
            for dst, src in zip(cache["state"], state):
                dst.copy_(src if heads == slice(None) else
                          tpm.all_gather_dim(src, tp.tp_group, 1))
    gelu = activation("gelu")                  # jax.nn.gelu's tanh form
    mlp = (par is not None and par.tp
           and p["up"]["w"].shape[1] < int(d * cfg.xlstm.proj_factor_slstm))
    if mlp:
        hh = tpm.copy_to_tp(hh, par)
    y = (gelu(hh @ p["up_gate"]["w"]) * (hh @ p["up"]["w"])) @ p["down"]["w"]
    return tpm.reduce_from_tp(y, par if mlp else None), cache


def init_slstm_cache(cfg: ModelConfig, batch: int, device="cpu") -> dict:
    xl = cfg.xlstm
    dh = cfg.d_model // xl.num_heads
    shape = (batch, xl.num_heads, dh)
    z = lambda: torch.zeros(shape, dtype=torch.float32,  # noqa: E731
                            device=device)
    return {"state": (z(), z(), z(), torch.full(shape, NEG_BIG,
                                                 dtype=torch.float32,
                                                 device=device))}
