"""Carry parameters between the JAX package and the port.

Both sides keep the same layout (conv weights HWIO, dense weights
(in, out), the same keys), so a conversion is the identity on the values:
the JAX side hands over numpy arrays (``jax.tree.map(np.asarray, p)``),
stacked (U, ...) or not, and gets numpy arrays back.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.utils.tree import tree_map


def params_from_numpy(tree, device) -> dict:
    """Numpy (or array-like) leaves -> tensors on ``device``, same dtype."""
    return tree_map(
        lambda a: torch.from_numpy(np.array(a, copy=True)).to(device), tree)


def params_to_numpy(tree) -> dict:
    """Tensor leaves -> numpy arrays on the host (the inverse)."""
    return tree_map(lambda t: t.detach().cpu().numpy(), tree)
