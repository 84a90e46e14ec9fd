"""Tensor parallelism over the "model" mesh dim, Megatron style.

The reference gets its tensor parallelism from GSPMD: its steps lay the
weights out by ``params_specs`` and XLA partitions the rest.  Here each
rank holds its block of every leaf (``sharding.rules.shard_params``) and
the layers reduce over the "model" group where a block's result is
partial:

- :func:`copy_to_tp`: identity forward, ``all_reduce`` of the gradient
  backward.  It stands where a replicated tensor enters a split block
  (the input of q/k/v, gate/up, the LM head; MLA's latents; the MoE's
  dispatched tokens and combine weights) and on each replicated leaf such
  a block uses (the q/k norms, the k/v projections when the kv heads do
  not divide the dim), whose gradients are each rank's part of the sum.
- :func:`reduce_from_tp`: ``all_reduce`` forward, identity backward, after
  a row-parallel product (o, down, the experts' combine) and the
  vocab-parallel embedding.
- :func:`reduce_scatter_to_tp`: the sum over the group, of which a rank
  keeps its block of one dim; its gradient is the ``all_gather``.  The
  RG-LRU's gates and the mLSTM's q/k/v and gates, whose weights split by
  rows, take it down to the rank's width or heads.
- :func:`gather_from_tp`: ``all_gather`` along a dim; the gradient is
  the rank's block of the summed gradient (``reduce_scatter``) when the
  ranks use the whole in parts (the mLSTM's packed ``[x_m ; z]``), or its
  block alone (``summed=False``) when each rank uses all of it alike
  (the sLSTM's hidden state before its MLP).
- :func:`vocab_parallel_embedding` and :func:`vocab_parallel_loss_sum`:
  the embedding rows and the head's columns split by vocabulary.

``all_reduce``, ``all_gather`` and ``reduce_scatter`` are the
collectives: gloo takes CUDA tensors for each when ranks share a card,
and the hand-written kernels get plain local tensors.

Which leaves a rank holds whole and which in part it reads from their
shapes against the config: the rules shard a dim only when it divides,
so a local dim smaller than the config's is this rank's block of it.  A
block whose leaves are all whole (a dim that does not divide) is computed
whole on every rank, with no collective.

The group reaches the layers in a :class:`Parallel` passed down from the
step (``par=``); ``None`` is one rank, the unchanged single-device path.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist
import torch.nn.functional as F


@dataclass(frozen=True)
class Parallel:
    """What a rank's layers need of the mesh.

    tp_group / tp_size / tp_rank: the "model" group (None at size 1).
    seq_groups / seq_size / seq_rank: the client-dim groups a decode
    cache's length is split over (batch 1, ``input_specs.cache_specs``),
    pod major, and this rank's slice; cache_len the whole cache length
    (the decode's ``max_len``)."""
    tp_group: object = None
    tp_size: int = 1
    tp_rank: int = 0
    seq_groups: tuple = ()
    seq_size: int = 1
    seq_rank: int = 0
    cache_len: int = 0

    @property
    def tp(self) -> bool:
        return self.tp_size > 1


def parallel_for(mesh, *, cache_split: bool = False,
                 cache_len: int = 0) -> Parallel | None:
    """The :class:`Parallel` of this rank of ``mesh`` (a DeviceMesh), or
    None when it has one "model" rank and no split cache."""
    from repro_torch.sharding.rules import as_abstract, data_axes
    shape = as_abstract(mesh).shape
    tp_size = shape.get("model", 1)
    kw = {}
    if tp_size > 1:
        kw = dict(tp_group=mesh.get_group("model"), tp_size=tp_size,
                  tp_rank=mesh.get_local_rank("model"))
    if cache_split:
        axes = data_axes(mesh)
        rank = 0
        for a in axes:
            rank = rank * shape[a] + mesh.get_local_rank(a)
        size = 1
        for a in axes:
            size *= shape[a]
        if size > 1:
            kw.update(seq_groups=tuple(mesh.get_group(a) for a in axes),
                      seq_size=size, seq_rank=rank, cache_len=cache_len)
    return Parallel(**kw) if kw else None


# ------------------------------------------------------- the Functions ----
class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


def all_gather_dim(x, group, dim: int):
    """The ranks' blocks of ``group`` joined along ``dim``, in rank
    order (outside autograd)."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dim)


def reduce_scatter_dim(x, group, dim: int):
    """This rank's block along ``dim`` of the sum over ``group`` (outside
    autograd): ``all_gather_dim``'s adjoint."""
    xt = x.movedim(dim, 0).contiguous()
    parts = list(xt.chunk(dist.get_world_size(group)))
    out = torch.empty_like(parts[0])
    dist.reduce_scatter(out, parts, group=group)
    return out.movedim(0, dim)


class _ReduceScatterTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return reduce_scatter_dim(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return all_gather_dim(g, ctx.group, ctx.dim), None, None


class _GatherTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim, rank, summed):
        ctx.group, ctx.dim, ctx.rank, ctx.summed = group, dim, rank, summed
        ctx.size = x.shape[dim]
        return all_gather_dim(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        if ctx.summed:
            g = reduce_scatter_dim(g, ctx.group, ctx.dim)
        else:
            g = g.narrow(ctx.dim, ctx.rank * ctx.size, ctx.size)
        return g.contiguous(), None, None, None, None


def copy_to_tp(x, par: Parallel | None):
    """Identity; the gradient is summed over the "model" group."""
    if par is None or not par.tp:
        return x
    return _CopyToTP.apply(x, par.tp_group)


def reduce_from_tp(x, par: Parallel | None):
    """The sum over the "model" group; the gradient passes as it is."""
    if par is None or not par.tp:
        return x
    return _ReduceFromTP.apply(x, par.tp_group)


def reduce_scatter_to_tp(x, par: Parallel | None, dim: int = -1):
    """This rank's block along ``dim`` of the sum over the "model" group;
    the gradient is gathered whole (``all_gather``)."""
    if par is None or not par.tp:
        return x
    return _ReduceScatterTP.apply(x, par.tp_group, dim % x.dim())


def gather_from_tp(x, par: Parallel | None, dim: int = -1, *,
                   summed: bool = True):
    """The "model" group's blocks of ``x`` joined along ``dim``.  The
    gradient of this rank's block is its block of the gradients summed
    over the group (``summed``: each rank uses its own part of the
    whole), or of this rank's gradient alone (each rank uses the whole
    alike)."""
    if par is None or not par.tp:
        return x
    return _GatherTP.apply(x, par.tp_group, dim % x.dim(), par.tp_rank,
                           summed)


def all_reduce_max(x, group):
    """The elementwise max over ``group``, outside autograd."""
    y = x.detach().contiguous().clone()
    dist.all_reduce(y, op=dist.ReduceOp.MAX, group=group)
    return y


def all_reduce_sum(x, groups):
    """The sum over each of ``groups`` in turn, outside autograd."""
    y = x.contiguous().clone()
    for g in groups:
        dist.all_reduce(y, group=g)
    return y


# ------------------------------------------------------ vocab parallel ----
def vocab_parallel_embedding(tokens, table, par: Parallel):
    """Rows [r*Vl, (r+1)*Vl) of the embedding on rank r: tokens outside
    them look up row 0 and are zeroed, then the ranks' rows are summed
    (exact: one nonzero term a token).  ``F.embedding`` keeps F2's repair
    (its backward does not depend on thread order)."""
    vl = table.shape[0]
    lo = par.tp_rank * vl
    outside = (tokens < lo) | (tokens >= lo + vl)
    local = torch.where(outside, torch.zeros_like(tokens), tokens - lo)
    x = F.embedding(local, table)
    x = x.masked_fill(outside[..., None], 0)
    return reduce_from_tp(x, par)


def vocab_parallel_loss_sum(lg, labels, par: Parallel):
    """sum(logsumexp - gold) over float32 logits split by vocabulary:
    ``lg`` (B,c,Vl) is rank r's columns [r*Vl, (r+1)*Vl).  The max over
    the group steadies the exponent (outside autograd, as
    ``torch.logsumexp``'s is); the exponent sums and the gold logits go
    in one ``all_reduce``."""
    vl = lg.shape[-1]
    lo = par.tp_rank * vl
    m = all_reduce_max(lg.amax(dim=-1), par.tp_group)           # (B,c)
    se = torch.exp(lg - m[..., None]).sum(dim=-1)
    lab = labels.long()
    inside = (lab >= lo) & (lab < lo + vl)
    idx = torch.where(inside, lab - lo, torch.zeros_like(lab))
    gold = lg.gather(-1, idx[..., None])[..., 0] * inside.to(lg.dtype)
    se, gold = reduce_from_tp(torch.stack([se, gold]), par).unbind(0)
    return (torch.log(se) + m - gold).sum()


# --------------------------------------------------------- GQA on ranks ---
def kv_heads_for(par: Parallel, num_heads: int, num_kv: int,
                 local_heads: int):
    """The kv heads rank ``par.tp_rank``'s query heads read, given that it
    holds query heads [r*Hl, (r+1)*Hl) of ``num_heads`` and every kv head:
    a slice (lo, hi) when its heads read whole, equal runs of consecutive
    kv heads (K2's grouping, h // (Hl / kv)), else a list of one kv head
    a query head."""
    group = num_heads // num_kv
    first = par.tp_rank * local_heads
    idx = [(first + i) // group for i in range(local_heads)]
    lo, hi = idx[0], idx[-1] + 1
    n = hi - lo
    if local_heads % n == 0 and idx == [lo + i // (local_heads // n)
                                        for i in range(local_heads)]:
        return lo, hi
    return idx
