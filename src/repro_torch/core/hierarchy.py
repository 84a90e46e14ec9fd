"""Hierarchical aggregation (paper Sec. II-B, Eqs. 4–7 and 14–16).

``repro.core.hierarchy``'s two renderings of the same math:
  - host side (fedsim): explicit weighted sums over lists of client trees
    (dicts of tensors), plain and participation-masked;
  - mesh side (phsfl): weighted sums over the "data" (an ES's clients)
    and "pod" (the CS's edge servers) dims of a ``DeviceMesh``, each rank
    holding one client's tree: the reference's ``lax.psum`` over a manual
    axis is ``dist.all_reduce`` (SUM) over that dim's process group.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs.base import HierarchyConfig
from repro_torch.utils.tree import tree_map, tree_weighted_sum


# --------------------------------------------------------- bookkeeping -----
def sgd_step_index(t2: int, t1: int, t0: int, h: HierarchyConfig) -> int:
    """Eq. (1): t = t2*k1*k0 + t1*k0 + t0."""
    return t2 * h.kappa1 * h.kappa0 + t1 * h.kappa0 + t0


def normalized_weights(sizes) -> np.ndarray:
    s = np.asarray(sizes, dtype=np.float64)
    assert (s >= 0).all() and s.sum() > 0
    return s / s.sum()


def es_assignment(num_clients: int, clients_per_es: int) -> np.ndarray:
    """The default client -> edge-server map: contiguous blocks (client u
    belongs to ES ``u // clients_per_es``)."""
    return np.arange(int(num_clients)) // int(clients_per_es)


# ------------------------------------------------------------ host side ----
def edge_aggregate(client_trees: list, alpha_u) -> object:
    """Eq. (4)/(14-15): w_b = sum_u alpha_u w_u  (alpha_u on the simplex)."""
    w = np.asarray(alpha_u, dtype=np.float64)
    assert abs(w.sum() - 1.0) < 1e-6, "alpha_u must sum to 1 within an ES"
    return tree_weighted_sum(client_trees, [float(v) for v in w])


def global_aggregate(edge_trees: list, alpha_b) -> object:
    """Eq. (6)/(16): w = sum_b alpha_b w_b."""
    w = np.asarray(alpha_b, dtype=np.float64)
    assert abs(w.sum() - 1.0) < 1e-6, "alpha_b must sum to 1"
    return tree_weighted_sum(edge_trees, [float(v) for v in w])


# ------------------------------------------- participation-masked (host) ----
def _masked_weighted_sum(trees: list, weights, mask, fallback):
    """Weighted sum over the sub-list where mask > 0, weights renormalized
    to the simplex over participants.  A full mask takes the exact
    unmasked code path (bit-for-bit ``tree_weighted_sum(trees,
    weights)``); an empty mask returns ``fallback`` (the previous model)
    or raises."""
    m = np.asarray(mask, dtype=np.float64)
    w = np.asarray(weights, dtype=np.float64)
    if not m.shape == w.shape == (len(trees),):
        raise ValueError(f"want mask and weights of shape ({len(trees)},); "
                         f"got {m.shape} and {w.shape}")
    if (m > 0).all():
        return tree_weighted_sum(trees, [float(v) for v in w])
    keep = np.flatnonzero(m > 0)
    if len(keep) == 0:
        if fallback is None:
            raise ValueError("no participants and no fallback model given")
        return fallback
    sub_w = w[keep]
    return tree_weighted_sum([trees[i] for i in keep],
                             [float(v) for v in sub_w / sub_w.sum()])


def masked_edge_aggregate(client_trees: list, alpha_u, mask,
                          fallback=None) -> object:
    """Eqs. (14-15) over the participating clients of one ES: the
    straggler mask zeroes dropped clients and the alpha_u weights
    renormalize over the survivors; with no survivors the ES keeps
    ``fallback`` (its previous edge model)."""
    return _masked_weighted_sum(client_trees, alpha_u, mask, fallback)


def masked_global_aggregate(edge_trees: list, alpha_b, mask,
                            fallback=None) -> object:
    """Eq. (16) over the ESs that had at least one participant this global
    round; alpha_b renormalizes over them."""
    return _masked_weighted_sum(edge_trees, alpha_b, mask, fallback)


# ------------------------------------------------------------ mesh side ----
def psum_weighted(tree, weight, group, agg_dtype=torch.float32):
    """sum_i weight_i * tree_i over the ranks of ``group`` (a mesh dim's
    process group), every rank getting the sum.

    ``weight`` is this rank's scalar aggregation weight (alpha_u or
    alpha_b, already normalized over the group).  The reduction runs in
    ``agg_dtype`` (float32 by default, the standard for parameter
    averaging), and the result is cast back to each leaf's dtype."""
    w = weight.to(agg_dtype)

    def agg(t):
        acc = t.to(agg_dtype) * w
        dist.all_reduce(acc, group=group)
        return acc.to(t.dtype)

    return tree_map(agg, tree)


def masked_psum_weighted(tree, weight, mask, fallback, group,
                         agg_dtype=torch.float32):
    """Participation-masked :func:`psum_weighted`.

    ``mask`` is this rank's 0/1 participation scalar.  Weights
    renormalize over the participating ranks; with none, every rank keeps
    its ``fallback`` tree (the model from before this round's local
    steps).  When ALL ranks participate the divisor is exactly 1.0:
    multiplying by a 1.0 mask and dividing by 1.0 are exact, so the result
    is bit-identical to the unmasked :func:`psum_weighted`."""
    m = mask.to(agg_dtype)
    w = weight.to(agg_dtype) * m
    # psum of (mask, 1, weight) in one collective: n_part, n_all, total
    stats = torch.stack([m, torch.ones_like(m), w])
    dist.all_reduce(stats, group=group)
    n_part, n_all, total = stats
    one = torch.ones((), dtype=agg_dtype, device=stats.device)
    denom = torch.where(n_part >= n_all, one,
                        torch.where(total > 0, total, one))

    def agg(t, fb):
        acc = t.to(agg_dtype) * w
        dist.all_reduce(acc, group=group)
        acc = acc / denom
        return torch.where(n_part > 0, acc.to(t.dtype), fb)

    return tree_map(agg, tree, fallback)


def edge_aggregate_mesh(tree, alpha_u_shard, mesh, agg_dtype=torch.float32):
    """Weighted aggregation over the "data" dim (clients within an ES)."""
    return psum_weighted(tree, alpha_u_shard, mesh.get_group("data"),
                         agg_dtype)


def global_aggregate_mesh(tree, alpha_b_shard, mesh,
                          agg_dtype=torch.float32):
    """Weighted aggregation over the "pod" dim (edge servers at the CS)."""
    return psum_weighted(tree, alpha_b_shard, mesh.get_group("pod"),
                         agg_dtype)
