"""Carry parameters between the JAX package and the port.

Both sides keep the same layout (conv and dense weights (in, ...out), the
same keys, scanned stages stacked on a leading dimension), so a
conversion is the identity on the values: the JAX side hands over numpy
arrays (``jax.tree.map(np.asarray, p)``), stacked (U, ...) or not, and
gets numpy arrays back.

bfloat16 has no numpy dtype of its own: JAX's arrays come out as
``ml_dtypes.bfloat16``, which ``torch.from_numpy`` refuses.  Both ways,
a bfloat16 leaf crosses as its raw 16 bits (``uint16``) and is viewed as
the other side's bfloat16, so the values are bit-identical.  The port
hands bfloat16 back as an ``ml_dtypes.bfloat16`` array when that package
is installed (it comes with jax), and as the raw ``uint16`` bits when not.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.utils.tree import tree_map


def _is_bfloat16(a: np.ndarray) -> bool:
    return a.dtype.name == "bfloat16"


def _to_tensor(a) -> torch.Tensor:
    a = np.array(a, copy=True)
    if _is_bfloat16(a):
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype != torch.bfloat16:
        return t.numpy()
    bits = t.view(torch.uint16).numpy()
    try:
        import ml_dtypes
    except ImportError:
        return bits
    return bits.view(ml_dtypes.bfloat16)


def params_from_numpy(tree, device) -> dict:
    """Numpy (or array-like) leaves -> tensors on ``device``, same dtype."""
    return tree_map(lambda a: _to_tensor(a).to(device), tree)


def params_to_numpy(tree) -> dict:
    """Tensor leaves -> numpy arrays on the host (the inverse)."""
    return tree_map(_to_numpy, tree)
