"""PHSFL training rounds (``repro.core.phsfl``).

Three strategies:

1. ``make_host_round``: every client owns a full model replica;
   parameters and optimizer states carry a leading client dimension C on
   one device.  One call of a round's ``fn`` is one edge round:

       kappa0 local SGD steps per client (no cross-client traffic)
       -> weighted mean over each ES's clients  (edge aggregation, 14-15)
       -> [global_sync] weighted mean over ESs  (global aggregation, 16)

2. ``make_phsfl_round``: the same round over a ``DeviceMesh`` of
   ("pod",) "data", "model" dims, one client per rank of the pod x data
   dims.  Each rank holds its client's (1, ...) slice of the stacked
   tensors and runs the same ``local_steps``; edge aggregation is a
   weighted ``all_reduce`` over the "data" group, global aggregation one
   over the "pod" group (``core.hierarchy``'s mesh half).

3. ``make_shared_server_step`` (beyond the paper, SFL-V2-like): one
   shared body and head, laid out as the reference's ``fsdp_tp`` (its
   "embed" dims split over the client dims), the small client block per
   client; the shared leaves are gathered at the step's start and their
   gradients summed over every client rank (reduce-scattered back to
   each rank's block), and the client blocks aggregate at the kappa0
   boundary (``sync_clients``).

The frozen head (Eq. 12) is an optimizer mask, so the head leaves never
move and the aggregation leaves them bit-identical across clients.

The reference maps its clients with ``jax.vmap``; here a loop over the
stacked (C, ...) tensors runs them one after another.  ``torch.func.vmap``
cannot map an autograd Function that launches a kernel through ctypes,
and only one client's step is alive at a time.  A host round holds three
stacked (C, ...) copies of the parameters at its peak (the round's
input, the clients' new parameters, the edge step's output), the
optimizer states, one client's step (its gradients and activations) and
the edge step's float32 copies of one leaf.

The reference lets GSPMD shard each client's replica over a "model" axis
(tensor parallelism).  The port's mesh rounds take a "model" dim above 1
for every family (``sharding.tensor_parallel``): each rank holds its
block of its client's replica (``sharding.rules.shard_params``), the
local steps reduce over the "model" group inside the layers, and the edge
and global aggregation sum each rank's block over the "data" and "pod"
groups as before.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch
import torch.distributed as dist

from repro_torch.configs.base import HierarchyConfig, TrainConfig
from repro_torch.core.hierarchy import (edge_aggregate_mesh,
                                        global_aggregate_mesh,
                                        masked_psum_weighted)
from repro_torch.core.split import (GLOBAL_TRAIN, HSFL_TRAIN, part_masks,
                                    split_spec_for, trainable_mask)
from repro_torch.models.init_utils import shape_generator
from repro_torch.models.registry import Model
from repro_torch.optim import (apply_updates, make_optimizer, masked,
                               zeros_view)
from repro_torch.sharding.rules import (add_client_axis, as_abstract,
                                        client_split_dims, data_axes,
                                        gather_dims, params_specs,
                                        reduce_scatter_dims)
from repro_torch.sharding.tensor_parallel import parallel_for
from repro_torch.telemetry import spans
from repro_torch.utils.tree import tree_leaves, tree_map


def abstract_params(model: Model, *, stacked_clients: int | None = None):
    """``model.init``'s tree on the meta device: every shape and dtype, no
    storage; stacked (C, ...) with ``stacked_clients``."""
    shapes = model.init(shape_generator())
    if stacked_clients is not None:
        shapes = tree_map(lambda s: s.new_empty((stacked_clients,
                                                 *s.shape)), shapes)
    return shapes


def local_steps(model: Model, opt, mask, tcfg: TrainConfig, par=None):
    """One client's kappa0 local SGD steps, the reference's ``_local_scan``
    as a loop, with its activation checkpointing (``tcfg.remat``; policy
    "full" is the wrapper's default, None).  Frozen leaves (mask False)
    take no gradient (a broadcast zero stands in for it) and are returned
    as they are: their update is zero either way.  ``par``: this rank's
    tensor-parallel block.  ``run``'s ``client`` labels its spans."""
    policy = None if tcfg.remat_policy == "full" else tcfg.remat_policy

    def run(p, s, batch_c, client=None):
        losses = []
        for k in range(batch_c["tokens"].shape[0]):
            mb = {name: v[k] for name, v in batch_c.items()}
            with spans.span("phsfl.local_step", client=client, step=k,
                            tokens=mb["tokens"].numel()):
                with spans.span("phsfl.forward"):
                    leaves = tree_map(
                        lambda x, m: x.detach().requires_grad_(m), p, mask)
                    loss = model.loss(leaves, mb, remat=tcfg.remat,
                                      remat_policy=policy, par=par)
                with spans.span("phsfl.backward"):
                    got = iter(torch.autograd.grad(
                        loss, [t for t in tree_leaves(leaves)
                               if t.requires_grad], allow_unused=True))
                    grads = tree_map(lambda t: next(got) if t.requires_grad
                                     else zeros_view(t), leaves)
                    del leaves
                with spans.span("phsfl.update"):
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
    params_spec: Any = None  # partition-spec tree of the stacked params
    #                          (mesh rounds)


def _tree_span(name: str, tree):
    """A span over an aggregation of ``tree``: its leaves and bytes
    (``spans.OFF`` while spans do not record)."""
    if not spans.on():
        return spans.OFF
    leaves = tree_leaves(tree)
    return spans.open(name, leaves=len(leaves),
                      bytes=sum(x.nbytes for x in leaves))


def _round_span(body, num_clients: int):
    """``body`` inside a ``phsfl.round`` span while spans record."""
    def fn(params, opt_state, batch, au, ab, mask):
        with spans.span("phsfl.round", clients=num_clients) as sp:
            if sp is not spans.OFF:
                sp.args["round"] = sp.index
            return body(params, opt_state, batch, au, ab, mask)
    return fn


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

    def body(params, opt_state, batch, au, ab, mask):
        if not built:
            built.append(local_steps(model, *build_optimizer(
                model, tcfg, cut, params=params), tcfg))
        local = built[0]
        new_p = tree_map(torch.empty_like, params)
        new_s = tree_map(torch.empty_like, opt_state)
        losses = []
        for c in range(num_clients):
            p, s, lc = local(tree_map(lambda x: x[c], params),
                             tree_map(lambda x: x[c], opt_state),
                             {k: v[c] for k, v in batch.items()}, client=c)
            for dst, src in zip(tree_leaves(new_p) + tree_leaves(new_s),
                                tree_leaves(p) + tree_leaves(s)):
                dst[c].copy_(src)
            del p, s
            losses.append(lc.mean())
        with _tree_span("phsfl.edge", new_p):
            p = _edge(new_p, params, au, mask)
        if global_sync:
            with _tree_span("phsfl.global", p):
                p = _global(p, ab, mask)
        return p, new_s, {"loss": torch.stack(losses).mean()}

    round_body = _round_span(body, num_clients)
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


# ------------------------------------------------- the mesh (one client a
# rank of the pod x data dims) ---------------------------------------------
def client_index(mesh) -> int:
    """This rank's client: its coordinate along the pod x data dims, pod
    major (client c sits in ES ``c // clients_per_pod``, as the host
    round's (B, Ub) grouping has it)."""
    names = as_abstract(mesh).axis_names
    coord = dict(zip(names, mesh.get_coordinate()))
    shape = as_abstract(mesh).shape
    c = 0
    for a in data_axes(mesh):
        c = c * shape[a] + coord[a]
    return c


def _client_ranks(mesh) -> int:
    """Ranks along the pod x data dims: the client slots."""
    n = 1
    for a in data_axes(mesh):
        n *= as_abstract(mesh).shape[a]
    return n


def _client_groups(mesh) -> list:
    return [mesh.get_group(a) for a in data_axes(mesh)]


def tensor_parallel(model: Model, mesh):
    """This rank's tensor-parallel block (``sharding.tensor_parallel.
    Parallel``), or None when the "model" dim is 1."""
    return parallel_for(mesh)


def make_phsfl_round(model: Model, hcfg: HierarchyConfig, tcfg: TrainConfig,
                     mesh, *, global_sync: bool,
                     participation: bool = False, cut=None) -> PHSFLRound:
    """One edge round over ``mesh`` (a ``DeviceMesh`` with a "data" dim,
    optionally "pod", and "model"), one client per rank of the pod x data
    dims, its replica split over the "model" dim (``tensor_parallel``).

    The fn takes the reference's arguments, each this rank's (1, ...)
    slice of the stacked tensors: params, opt_state, batch, alpha_u,
    alpha_b and, with ``participation=True``, the 0/1 mask.  The rank runs
    its client's local steps (the host round's ``local_steps``), then the
    weighted edge ``all_reduce`` over "data" and, when ``global_sync``
    holds and the mesh has "pod", the global one over "pod".  Masked, the
    weights renormalize over the participating clients, an ES with none
    keeps its pre-round models, and an ES joins the global step iff it had
    a participant; an all-ones mask is bit-identical to the unmasked
    round.  The loss is the mean over all clients.  ``cut`` declares the
    split boundary (a Remark-2 no-op on numerics)."""
    par = tensor_parallel(model, mesh)
    num_clients = _client_ranks(mesh)
    me = client_index(mesh)
    groups = _client_groups(mesh)
    with_pod = "pod" in as_abstract(mesh).axis_names
    agg = getattr(torch, tcfg.agg_dtype)
    built = []              # the local steps, from the first call's paths

    def body(params, opt_state, batch, au, ab, mask):
        p_prev = tree_map(lambda x: x[0], params)
        if not built:
            built.append(local_steps(model, *build_optimizer(
                model, tcfg, cut, params=p_prev), tcfg, par))
        p, s, losses = built[0](p_prev, tree_map(lambda x: x[0], opt_state),
                                {k: v[0] for k, v in batch.items()},
                                client=me)
        with _tree_span("phsfl.edge", p):
            if mask is None:
                p = edge_aggregate_mesh(p, au[0], mesh, agg)
            else:
                m = mask[0].to(agg)
                p = masked_psum_weighted(p, au[0], m, p_prev,
                                         mesh.get_group("data"), agg)
        if global_sync and with_pod:
            with _tree_span("phsfl.global", p):
                if mask is None:
                    p = global_aggregate_mesh(p, ab[0], mesh, agg)
                else:
                    # an ES joins the global round iff it had a participant
                    n = m.clone()
                    dist.all_reduce(n, group=mesh.get_group("data"))
                    es_m = (n > 0).to(agg)
                    p = masked_psum_weighted(p, ab[0], es_m, p,
                                             mesh.get_group("pod"), agg)
        loss = losses.mean()
        for g in groups:                        # pmean over each client dim
            dist.all_reduce(loss, group=g)
            loss = loss / dist.get_world_size(g)
        return (tree_map(lambda x: x.unsqueeze(0), p),
                tree_map(lambda x: x.unsqueeze(0), s), {"loss": loss})

    per_client = _round_span(body, num_clients)
    if participation:
        round_fn = per_client
    else:
        def round_fn(params, opt_state, batch, au, ab):
            return per_client(params, opt_state, batch, au, ab, None)
    spec = add_client_axis(params_specs(abstract_params(model), model.axes(),
                                        mesh, mode="tp"), mesh)
    return PHSFLRound(fn=round_fn, num_clients=num_clients,
                      params_spec=spec)


# ---------------------------------------------- shared-server (SFL-V2) -----
@dataclass
class SharedServerStep:
    fn: Callable            # (params, opt_state, batch) -> (params, opt,
    #                          metrics)
    sync_clients: Callable  # (params, do_global: bool) -> params
    client_mask: Any        # tree of bools: True on the client block
    clients: range          # the clients this rank holds, in order


def local_clients(mesh, num_clients: int) -> range:
    """The contiguous block of ``num_clients`` clients on this rank: an
    equal share per rank of the pod x data dims, in client order."""
    ranks = _client_ranks(mesh)
    if num_clients % ranks:
        raise ValueError(f"{num_clients} clients do not split over "
                         f"{ranks} ranks")
    per = num_clients // ranks
    first = client_index(mesh) * per
    return range(first, first + per)


def make_shared_server_step(model: Model, hcfg: HierarchyConfig,
                            tcfg: TrainConfig, mesh,
                            num_clients: int) -> SharedServerStep:
    """Beyond-paper mode: a shared body and head, a client block per
    client.

    params: the client-block leaves carry a leading dim of this rank's
    clients (``local_clients``; all ``num_clients`` at world size 1) and
    are whole over "model", as the reference lays them out; the body and
    head leaves are this rank's block under ``fsdp_tp``, the reference's
    layout: split over "model" (``tensor_parallel``) and, along their
    "embed" dims, over the client dims.  ``fn`` gathers those "embed"
    blocks whole, then runs one SGD step on the mean over ALL clients of
    each client's loss under its merged tree (its client block, the
    shared rest): a loop over this rank's clients.  A gathered leaf's
    gradient is reduce-scattered back to the rank's block (summed over
    every client rank), a shared leaf held whole over the client dims (a
    dim that does not divide, or a leaf given whole) has its gradient
    all-reduced over them, and the client leaves' gradients stay on their
    rank; then the masked update of each rank's blocks.  ``batch`` leaves
    are (clients on this rank, ...).  ``sync_clients(params, do_global)``
    replaces each client block by the unweighted mean over its pod's
    clients, or over all clients."""
    par = tensor_parallel(model, mesh)
    spec = split_spec_for(model.cfg)
    whole = abstract_params(model)
    fsdp = params_specs(whole, model.axes(), mesh, mode="fsdp_tp")
    client_mask = part_masks(whole, spec)["client"]
    mine = local_clients(mesh, num_clients)
    groups = _client_groups(mesh)
    shape = as_abstract(mesh).shape
    pods = shape.get("pod", 1)
    per_pod = num_clients // pods
    built = []              # (optimizer, mask), from the first call's paths

    def step(params, opt_state, batch):
        if not built:
            built.append(build_optimizer(model, tcfg, params=params))
        opt, mask = built[0]
        dims = tree_map(lambda c, x, w, sp: [] if c else client_split_dims(
            tuple(x.shape), tuple(w.shape), sp, mesh), client_mask, params,
            whole, fsdp)
        leaves = tree_map(lambda x, dd, m: gather_dims(
            x.detach(), dd, mesh).requires_grad_(m), params, dims, mask)
        total = torch.zeros((), dtype=torch.float32,
                            device=tree_leaves(params)[0].device)
        for i in range(len(mine)):
            merged = tree_map(lambda c, x: x[i] if c else x, client_mask,
                              leaves)
            loss = model.loss(merged, {k: v[i] for k, v in batch.items()},
                              remat=tcfg.remat, par=par) / num_clients
            loss.backward()
            total = total + loss.detach()

        def grad(c, t, m, dd):
            if t.grad is None:          # a frozen leaf: zeros of its block
                return None
            if c:
                return t.grad
            if dd:                  # a gathered leaf: back to the block
                return reduce_scatter_dims(t.grad, dd, mesh)
            g = t.grad
            for grp in groups:
                dist.all_reduce(g, group=grp)
            return g

        grads = tree_map(grad, client_mask, leaves, mask, dims)
        grads = tree_map(lambda g, x: zeros_view(x) if g is None else g,
                         grads, params)
        del leaves
        for grp in groups:
            dist.all_reduce(total, group=grp)
        upd, opt_state = opt.update(grads, opt_state, params)
        return apply_updates(params, upd, mask), opt_state, {"loss": total}

    def sync_clients(params, do_global: bool):
        """The kappa0-boundary aggregation of the client blocks."""
        def agg(c, x):
            if not c:
                return x
            acc = x.sum(dim=0, keepdim=True)
            dist.all_reduce(acc, group=mesh.get_group("data"))
            if do_global and "pod" in shape:
                dist.all_reduce(acc, group=mesh.get_group("pod"))
            mean = acc / (num_clients if do_global else per_pod)
            return mean.expand(x.shape).contiguous()

        return tree_map(agg, client_mask, params)

    return SharedServerStep(fn=step, sync_clients=sync_clients,
                            client_mask=client_mask, clients=mine)


def init_shared_server_params(model: Model, gen: torch.Generator,
                              num_clients: int):
    """One init from ``gen``, the client-block leaves stacked (C, ...)."""
    p = model.init(gen)
    masks = part_masks(p, split_spec_for(model.cfg))
    return tree_map(lambda m, x: x.unsqueeze(0).expand(
        num_clients, *x.shape).contiguous() if m else x, masks["client"], p)
