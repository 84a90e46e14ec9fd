"""PHSFL training rounds on one device (``repro.core.phsfl``'s host half).

Every client owns a full model replica: parameters and optimizer states
carry a leading client dimension C.  One call of a round's ``fn`` is one
edge round:

    kappa0 local SGD steps per client (no cross-client traffic)
    -> weighted mean over each ES's clients   (edge aggregation, Eqs. 14-15)
    -> [global_sync] weighted mean over ESs   (global aggregation, Eq. 16)

The frozen head (Eq. 12) is an optimizer mask, so the head leaves never
move and the aggregation leaves them bit-identical across clients.

The reference maps its clients with ``jax.vmap``; here a loop over the
stacked (C, ...) tensors runs them one after another.  ``torch.func.vmap``
cannot map an autograd Function that launches a kernel through ctypes,
and only one client's step is alive at a time.  A round holds three
stacked (C, ...) copies of the parameters at its peak (the round's
input, the clients' new parameters, the edge step's output), the
optimizer states, one client's step (its gradients and activations) and
the edge step's float32 copies of one leaf.  The mesh rounds
(``make_phsfl_round``, ``make_shared_server_step``) come with the mesh
slice (ROADMAP §1).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from repro_torch.configs.base import HierarchyConfig, TrainConfig
from repro_torch.core.split import (GLOBAL_TRAIN, HSFL_TRAIN, split_spec_for,
                                    trainable_mask)
from repro_torch.models.registry import Model
from repro_torch.optim import (apply_updates, make_optimizer, masked,
                               zeros_view)
from repro_torch.utils.tree import tree_leaves, tree_map


def local_steps(model: Model, opt, mask):
    """One client's kappa0 local SGD steps, the reference's ``_local_scan``
    as a loop.  Frozen leaves (mask False) take no gradient (a broadcast
    zero stands in for it) and are returned as they are: their update is
    zero either way."""
    def run(p, s, batch_c):
        losses = []
        for k in range(batch_c["tokens"].shape[0]):
            mb = {name: v[k] for name, v in batch_c.items()}
            leaves = tree_map(lambda x, m: x.detach().requires_grad_(m),
                              p, mask)
            loss = model.loss(leaves, mb)
            got = iter(torch.autograd.grad(
                loss, [t for t in tree_leaves(leaves) if t.requires_grad],
                allow_unused=True))
            grads = tree_map(lambda t: next(got) if t.requires_grad
                             else zeros_view(t), leaves)
            del leaves
            upd, s = opt.update(grads, s, p)
            p = apply_updates(p, upd, mask)
            losses.append(loss.detach())
        return p, s, torch.stack(losses)

    return run


def build_optimizer(model: Model, tcfg: TrainConfig, cut=None, *, params):
    """Masked optimizer implementing the PHSFL frozen head (Eq. 12).

    The mask comes from the paths of ``params`` (one replica, or the
    stacked tree: the paths are the same).  ``cut`` re-partitions the
    client/body boundary (see ``split_spec_for``); the head, the only part
    the mask distinguishes, is the same at every cut: the paper's Remark
    2, the round numerics cannot depend on the cut."""
    spec = split_spec_for(model.cfg, cut)
    phase = GLOBAL_TRAIN if tcfg.freeze_head else HSFL_TRAIN
    mask = trainable_mask(params, spec, phase)
    opt = make_optimizer(tcfg.optimizer, tcfg.learning_rate,
                         weight_decay=tcfg.weight_decay)
    return masked(opt, mask), mask


@dataclass
class PHSFLRound:
    """One edge round (optionally with global sync)."""
    fn: Callable            # (params, opt_state, batch, alpha_u, alpha_b
    #                          [, mask]) -> (params, opt_state, metrics)
    num_clients: int


def _lead(t: torch.Tensor, lead: tuple, ndim: int) -> torch.Tensor:
    """``t`` of shape ``lead`` viewed against a leaf of ``ndim`` trailing
    dims after them."""
    return t.reshape(*lead, *(1,) * ndim)


def make_host_round(model: Model, hcfg: HierarchyConfig, tcfg: TrainConfig,
                    *, num_clients: int, global_sync: bool,
                    participation: bool = False, cut=None) -> PHSFLRound:
    """One edge round on one device, the reference's mesh-free mirror.

    Each client runs the same local steps, then edge aggregation is a
    weighted sum over each ES's client group in ``agg_dtype`` (and, when
    ``global_sync``, a weighted sum over ES groups by alpha_b), reshaped
    (B, Ub, ...) and broadcast back as the reference does.  Optimizer
    states stay per client.  ``hcfg.num_edge_servers`` groups the leading
    client dim; alpha_u must be normalized within each group.

    With ``participation=True`` the fn takes a sixth argument, a (C,) 0/1
    mask: the weights renormalize over the participating clients, an ES
    with none keeps its pre-round models, and only ESs with a participant
    join the global step.  An all-ones mask is bit-identical to the
    unmasked round.  ``cut`` declares the split boundary (a Remark-2
    no-op on numerics).
    """
    if tcfg.remat:
        raise NotImplementedError(
            "activation checkpointing of the trunk (TrainConfig.remat) "
            "comes with a later slice of the port (ROADMAP.md §1 item 6); "
            "pass remat=False")
    B = hcfg.num_edge_servers
    if num_clients % B:
        raise ValueError(f"{num_clients} clients do not split into {B} ESs")
    Ub = num_clients // B
    agg = getattr(torch, tcfg.agg_dtype)

    def _edge(p, p_prev, au, mask):
        w = au.to(agg).reshape(B, Ub)
        if mask is not None:
            m = mask.to(agg).reshape(B, Ub)
            w = w * m
            tot = w.sum(dim=1, keepdim=True)
            n = m.sum(dim=1, keepdim=True)
            one = torch.ones((), dtype=agg, device=w.device)
            denom = torch.where(n >= Ub, one, torch.where(tot > 0, tot, one))

        def one_leaf(x, fb):
            nd = x.dim() - 1
            xr = x.to(agg).reshape(B, Ub, *x.shape[1:])
            acc = (xr * _lead(w, (B, Ub), nd)).sum(dim=1, keepdim=True)
            if mask is not None:
                acc = acc / _lead(denom, (B, 1), nd)
            out = acc.expand(xr.shape).to(x.dtype)
            if mask is not None:
                out = torch.where(_lead(n > 0, (B, 1), nd), out,
                                  fb.reshape(xr.shape))
            return out.reshape(x.shape)

        return tree_map(one_leaf, p, p_prev)

    def _global(p, ab, mask):
        wb = ab.to(agg).reshape(B, Ub)[:, :1]                    # (B, 1)
        if mask is not None:
            m = (mask.to(agg).reshape(B, Ub).sum(dim=1, keepdim=True)
                 > 0).to(agg)                                    # ES mask
            wb = wb * m
            tot = wb.sum()
            n = m.sum()
            one = torch.ones((), dtype=agg, device=wb.device)
            denom = torch.where(n >= B, one, torch.where(tot > 0, tot, one))

        def one_leaf(x):
            nd = x.dim() - 1
            xr = x.to(agg).reshape(B, Ub, *x.shape[1:])
            acc = (xr * _lead(wb, (B, 1), nd)).sum(dim=0, keepdim=True)
            if mask is not None:
                acc = acc / denom
                acc = torch.where(n > 0, acc, xr)   # nobody synced: keep
            return acc.expand(xr.shape).to(x.dtype).reshape(x.shape)

        return tree_map(one_leaf, p)

    built = []              # the local steps, from the first call's paths

    def round_body(params, opt_state, batch, au, ab, mask):
        if not built:
            built.append(local_steps(model, *build_optimizer(
                model, tcfg, cut, params=params)))
        local = built[0]
        new_p = tree_map(torch.empty_like, params)
        new_s = tree_map(torch.empty_like, opt_state)
        losses = []
        for c in range(num_clients):
            p, s, lc = local(tree_map(lambda x: x[c], params),
                             tree_map(lambda x: x[c], opt_state),
                             {k: v[c] for k, v in batch.items()})
            for dst, src in zip(tree_leaves(new_p) + tree_leaves(new_s),
                                tree_leaves(p) + tree_leaves(s)):
                dst[c].copy_(src)
            del p, s
            losses.append(lc.mean())
        p = _edge(new_p, params, au, mask)
        if global_sync:
            p = _global(p, ab, mask)
        return p, new_s, {"loss": torch.stack(losses).mean()}

    if participation:
        round_fn = round_body
    else:
        def round_fn(params, opt_state, batch, au, ab):
            return round_body(params, opt_state, batch, au, ab, None)
    return PHSFLRound(fn=round_fn, num_clients=num_clients)


def init_stacked_params(model: Model, gen: torch.Generator,
                        num_clients: int):
    """Identical per-client replicas (C, ...) of one init drawn from
    ``gen`` on its device."""
    return stack_replicas(model.init(gen), num_clients)


def stack_replicas(tree, num_clients: int):
    """(C, ...) copies of every leaf of ``tree``."""
    return tree_map(lambda x: x.unsqueeze(0).expand(num_clients, *x.shape)
                    .contiguous(), tree)
