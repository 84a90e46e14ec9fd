"""Hierarchical aggregation (paper Sec. II-B, Eqs. 4–7 and 14–16).

The host half of ``repro.core.hierarchy``: bookkeeping and explicit
weighted sums over lists of client trees (dicts of tensors).  The masked
variants and the mesh half wait for the wireless and mesh slices.
"""

from __future__ import annotations

import numpy as np

from repro_torch.configs.base import HierarchyConfig
from repro_torch.utils.tree import tree_weighted_sum


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
