"""Mixture-of-Experts FFN with token-choice top-k routing
(``repro.models.moe``).

Covers both MoE architectures: olmoe-1b-7b (64 experts, top-8, no shared
experts) and deepseek-v2-236b (160 routed top-6 + 2 shared experts, after
a first dense layer).

The reference sorts the (token, expert) pairs by expert and runs its
grouped matmuls with ``jax.lax.ragged_dot``, a library op outside any
Pallas kernel.  Here each expert's contiguous segment of the sorted pairs
goes through ``torch.matmul``: one host read of the group sizes per call
(counted in ``group_size_reads``), and an expert with no tokens is
skipped.

Under autograd the expert loop is one node (``_GroupedExperts``).  Left
to autograd, each expert's slice of a stacked ``(E, d, f)`` leaf
(``w[e]``) and of the dispatched rows (``xs[pos:pos + g]``) has a
backward that fills a zero tensor the size of the whole leaf (or of
``xs``) and writes one slice into it, and autograd then adds the E
copies.  At olmoe-1b-7b's widths in bf16 (4 x 2048 tokens) each leaf
and ``xs`` are 268 MB, so a layer's backward moved ~270 GB: 100.5 ms on
an NVIDIA H100 80GB HBM3, against ~10 ms of device work through the
node.  The node's forward is the same loop (the same ops, order and
dtypes) and keeps what autograd keeps of it: each expert's gate
pre-activation, activation, up output and ``h`` (recomputing the two
would cost two launches an expert in a backward that its host launches
pace).  Its backward allocates each gradient once and writes each
expert's products into its slice with the ops autograd runs on the
slice (``torch.mm(..., out=)``, the activation's own backward; the
input's two products rounded apart, then added, as autograd sums them),
so the gradients equal autograd's bit for bit; the slices of experts
without pairs are zeroed.  The node counts its backwards in
``grouped_backwards``.  Under ``no_grad`` (serving, the head bank's
trunk) the loop runs as it is.

The reference's combine is a scatter-add (``.at[st].add``);
on the card ``index_add_`` is atomic and does not repeat, so the pairs
are gathered back to (N, K, D) by the inverse permutation and added over
K in a fixed order instead.  The dispatch gathers the K-fold repeated
tokens by the sort's permutation for the same reason: its backward then
sums each token's K gradients in a fixed order, and a backward pass
repeats bit for bit.  Casts follow the reference: the router in
float32, top-k weights renormalised with a 1e-9 clamp, the weights cast
to the expert output's dtype before the product, the combine in that
dtype, and the Switch auxiliary loss in float32.

Traced on fake tensors (the dry run: shapes, no data) the group sizes
cannot be read: the segments then take an even split of the pairs.

Under tensor parallelism (``par``) the experts split over the "model"
dim (the rules' "expert" axis; when the count does not divide, their
"mlp" width splits instead).  Every rank routes every token (the router
and the auxiliary loss are replicated, their gradients counted once),
runs its own experts on their contiguous run of the sorted pairs (one
host read of its group sizes and of the run's start), and combines its
experts' outputs: the other pairs add zeros.  The ranks' partial outputs
are summed (``reduce_from_tp``).  The dispatched tokens and the combine
weights take the gradient's sum over the dim (``copy_to_tp``), since
each rank's experts see only their pairs.  The shared experts are a
column- and row-parallel MLP (``layers.mlp_apply``).
"""

from __future__ import annotations

import math

import torch
from torch.autograd.function import once_differentiable

from repro_torch.configs.base import ModelConfig
from repro_torch.hopper.dispatch import is_fake
from repro_torch.models.init_utils import dense, dense_axes, truncated_normal
from repro_torch.models.layers import (activation, activation_backward,
                                      mlp_apply)
from repro_torch.sharding import tensor_parallel as tpm
from repro_torch.telemetry import spans

group_size_reads = 0      # host reads of the group sizes in this process
grouped_backwards = 0     # MoE layer backwards through _GroupedExperts


def _expert_loop(xs, w_gate, w_up, w_down, sizes, act, keep=None):
    """The experts' outputs, one per expert with pairs: ``xs``'s segments
    of ``sizes`` rows through that expert's gated MLP.  ``keep`` (a list)
    takes each one's gate pre-activation, activation, up output and
    ``h``."""
    segs, pos = [], 0
    for e, g in enumerate(sizes):
        if g:
            xe = xs[pos:pos + g]
            a = xe @ w_gate[e]
            ha = act(a)
            u = xe @ w_up[e]
            h = ha * u
            segs.append(h @ w_down[e])
            if keep is not None:
                keep += [a, ha, u, h]
            pos += g
    return segs


class _GroupedExperts(torch.autograd.Function):
    """The expert loop as one autograd node (module docstring): the
    forward is :func:`_expert_loop`; the backward writes each expert's
    products into its slice of the stacked gradients and of ``xs``'s,
    each allocated once, with the ops autograd would run on each slice."""

    @staticmethod
    def forward(ctx, xs, w_gate, w_up, w_down, sizes, act_name):
        keep = []
        y = torch.cat(_expert_loop(xs, w_gate, w_up, w_down, sizes,
                                   activation(act_name), keep))
        ctx.sizes, ctx.act_name = sizes, act_name
        ctx.save_for_backward(xs, w_gate, w_up, w_down, *keep)
        return y

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        global grouped_backwards
        grouped_backwards += 1
        xs, w_gate, w_up, w_down, *keep = ctx.saved_tensors
        act_grad = activation_backward(ctx.act_name)
        need_x, need_g, need_u, need_d = ctx.needs_input_grad[:4]
        gx = torch.empty_like(xs) if need_x else None
        gg, gu, gd = (torch.empty_like(w) if need else None for w, need in
                      ((w_gate, need_g), (w_up, need_u), (w_down, need_d)))
        kept, pos = iter(keep), 0
        for e, g in enumerate(ctx.sizes):
            if not g:
                for gw in (gg, gu, gd):
                    if gw is not None:
                        gw[e].zero_()
                continue
            xe, dye = xs[pos:pos + g], dy[pos:pos + g]
            a, ha, u, h = next(kept), next(kept), next(kept), next(kept)
            if need_d:
                torch.mm(h.t(), dye, out=gd[e])
            if need_x or need_g or need_u:
                dh = dye.mm(w_down[e].t())
                da = act_grad(dh * u, a) if need_g or need_x else None
                du = dh * ha if need_u or need_x else None
                if need_g:
                    torch.mm(xe.t(), da, out=gg[e])
                if need_u:
                    torch.mm(xe.t(), du, out=gu[e])
                if need_x:
                    # the two products round apart and then add, as
                    # autograd sums a tensor's gradients (addmm would not)
                    gxe = torch.mm(da, w_gate[e].t(), out=gx[pos:pos + g])
                    gxe.add_(du.mm(w_up[e].t()))
            pos += g
        return gx, gg, gu, gd, None, None


def _experts(gen: torch.Generator, e: int, d_in: int, d_out: int, dtype):
    """(E, d_in, d_out) expert weights: truncated normal / sqrt(d_in)."""
    return truncated_normal(gen, (e, d_in, d_out), 1.0 / math.sqrt(d_in),
                            dtype)


def moe_init(gen: torch.Generator, cfg: ModelConfig, dtype=None) -> dict:
    dtype = dtype or getattr(torch, cfg.dtype)
    moe = cfg.moe
    e, d, f = moe.num_experts, cfg.d_model, moe.d_ff_expert
    p = {
        "router": dense(gen, d, e, dtype=torch.float32),  # router in f32
        "w_gate": _experts(gen, e, d, f, dtype),
        "w_up": _experts(gen, e, d, f, dtype),
        "w_down": _experts(gen, e, f, d, dtype),
    }
    if moe.num_shared_experts:
        fs = moe.d_ff_shared * moe.num_shared_experts
        p["shared"] = {
            "gate": dense(gen, d, fs, dtype=dtype),
            "up": dense(gen, d, fs, dtype=dtype),
            "down": dense(gen, fs, d, dtype=dtype),
        }
    return p


def moe_axes(cfg: ModelConfig) -> dict:
    a = {"router": dense_axes(("embed", None)),
         "w_gate": ("expert", "embed", "mlp"),
         "w_up": ("expert", "embed", "mlp"),
         "w_down": ("expert", "mlp", "embed")}
    if cfg.moe.num_shared_experts:
        a["shared"] = {"gate": dense_axes(("embed", "mlp")),
                       "up": dense_axes(("embed", "mlp")),
                       "down": dense_axes(("mlp", "embed"))}
    return a


def route(p, cfg: ModelConfig, flat):
    """Router of (N, D) tokens: the renormalised top-k weights (N, K),
    experts (N, K) and pairs routed to each expert (E,), and the Switch
    load-balance loss (float32 scalar): E x sum over experts of (fraction
    of routed pairs) x (mean router probability)."""
    moe = cfg.moe
    n = flat.shape[0]
    logits = flat.to(torch.float32) @ p["router"]["w"]          # (N, E)
    probs = torch.softmax(logits, dim=-1)
    top_w, top_e = torch.topk(probs, moe.top_k, dim=-1)         # (N, K)
    top_w = top_w / top_w.sum(-1, keepdim=True).clamp_min(1e-9)
    flat_e = top_e.reshape(-1)
    counts = torch.zeros(moe.num_experts, dtype=torch.int64,
                         device=top_e.device).scatter_add_(
        0, flat_e, torch.ones_like(flat_e))
    tokens_per_expert = counts.to(torch.float32) / (n * moe.top_k)
    aux = moe.num_experts * (tokens_per_expert * probs.mean(dim=0)).sum()
    return top_w, top_e, counts, aux


def _local_experts(p, cfg: ModelConfig, par):
    """(first expert, experts held, whether this rank's expert outputs
    are partial: its experts or their "mlp" width a block)."""
    moe = cfg.moe
    el, f = p["w_gate"].shape[0], p["w_gate"].shape[-1]
    split = par is not None and par.tp and (el < moe.num_experts
                                            or f < moe.d_ff_expert)
    first = par.tp_rank * el if split and el < moe.num_experts else 0
    return first, el, split


def moe_apply(p, cfg: ModelConfig, x, *, act_name: str | None = None,
              par=None):
    """x: (B,S,D) -> (out (B,S,D) in x's dtype, aux_loss float32 scalar).
    ``par``: this rank's tensor-parallel block (module docstring).

    Spans (``telemetry.spans``, while recording): ``moe.ffn`` (args: the
    MoE layer's index in its forward, the pairs this rank's experts run)
    over ``moe.route``, ``moe.dispatch`` (the sort, the group-size read,
    the gather), ``moe.experts`` (the expert loop) and ``moe.combine``
    (the shared experts' MLP included), and ``moe.ffn.backward``."""
    global group_size_reads
    moe = cfg.moe
    act = activation(act_name or cfg.act)
    b, s, d = x.shape
    on = spans.on()
    if on:
        ffn = spans.open("moe.ffn")
        ffn.args["layer"] = ffn.index
        mark, (x,) = spans.mark_inputs(ffn, x)
    with spans.span("moe.route"):
        flat = x.reshape(b * s, d)
        top_w, top_e, counts, aux = route(p, cfg, flat)

    with spans.span("moe.dispatch"):
        first, el, split = _local_experts(p, cfg, par)
        if split:
            flat_in = tpm.copy_to_tp(flat, par)
            top_w = tpm.copy_to_tp(top_w, par)
        else:
            flat_in = flat

        # ---- sort token-expert pairs by expert (stable, as jnp.argsort)
        flat_e = top_e.reshape(-1)                              # (N*K,)
        nk = flat_e.numel()
        order = torch.argsort(flat_e, stable=True)
        if is_fake(counts):
            # tracing without data (the dry run): an even split of the
            # pairs
            q, r = divmod(nk, moe.num_experts)
            even = [q + (e < r) for e in range(moe.num_experts)]
            start, sizes = sum(even[:first]), even[first:first + el]
        else:
            # this rank's experts' run of the sorted pairs: its start and
            # sizes in one host read
            got = torch.cat([counts[:first].sum()[None],
                             counts[first:first + el]]).tolist()
            start, sizes = got[0], got[1:]
            group_size_reads += 1
        stop = start + sum(sizes)
        # flat[order // K], as a permutation of the K-fold repeated rows:
        # its backward scatters unique indices and sums the K copies of a
        # token in a fixed order (a gather of repeated rows accumulates in
        # thread order)
        xs = flat_in.repeat_interleave(moe.top_k, 0)[order[start:stop]]

    # ---- grouped matmuls, one expert's segment at a time ----
    with spans.span("moe.experts"):
        ws = (p["w_gate"], p["w_up"], p["w_down"])
        if stop > start and torch.is_grad_enabled() and any(
                t.requires_grad for t in (xs, *ws)):
            segs = [_GroupedExperts.apply(xs, *ws, sizes,
                                          act_name or cfg.act)]
        else:
            segs = _expert_loop(xs, *ws, sizes, act)
        if start or stop < nk:          # the other ranks' pairs add zeros
            zero = lambda n: xs.new_zeros((n, d))  # noqa: E731
            segs = [zero(start), *segs, zero(nk - stop)]
        y = torch.cat(segs)                                     # (N*K, D)

    # ---- combine: back to (N, K, D) by the inverse permutation ----
    with spans.span("moe.combine"):
        inv = torch.empty_like(order)
        inv[order] = torch.arange(order.numel(), device=order.device)
        yk = y[inv].reshape(b * s, moe.top_k, d)
        wk = top_w.to(y.dtype)
        out = yk[:, 0] * wk[:, 0, None]
        for j in range(1, moe.top_k):
            out = out + yk[:, j] * wk[:, j, None]
        if split:
            out = tpm.reduce_from_tp(out, par)

        if moe.num_shared_experts:
            fs = moe.d_ff_shared * moe.num_shared_experts
            out = out + mlp_apply(p["shared"], flat, act_name or cfg.act,
                                  par=par, d_ff=fs)
        out = out.reshape(b, s, d).to(x.dtype)
    if on:
        ffn.args["pairs"] = stop - start
        out = spans.mark_output(mark, out)
        spans.close(ffn)
    return out, aux.to(torch.float32)
