"""Parameter-creation helpers (``repro.models.init_utils``).

Every draw happens on its generator's device.  A model at full width
holds billions of parameters, so the LM path draws them on the card with
a CUDA generator: drawing on the host and copying would take minutes.
A ``shape_generator()`` puts the draws on the meta device: the tree then
has every shape and dtype and holds no values, which is all the byte
accounting (``core.comm``) and the sharding rules need.  Each
``*_axes`` function gives its init's tree with logical axis names for
leaves.
"""

from __future__ import annotations

import math

import torch


class _ShapeGenerator(torch.Generator):
    """A generator whose ``device`` is the meta device: tensors made on
    it have shapes and no storage, and a draw from it is a no-op."""

    device = torch.device("meta")


def shape_generator() -> torch.Generator:
    """A generator for counting parameters without drawing them (a
    ``torch.Generator(device="meta")`` cannot be made)."""
    return _ShapeGenerator()


def truncated_normal(gen: torch.Generator, shape, scale,
                     dtype=torch.float32) -> torch.Tensor:
    """A standard normal truncated to [-2, 2], times ``scale``, drawn from
    ``gen`` in float32 (the reference's ``truncated_normal``).  The draw
    happens on ``gen``'s device."""
    t = torch.empty(shape, dtype=torch.float32, device=gen.device)
    torch.nn.init.trunc_normal_(t, mean=0.0, std=1.0, a=-2.0, b=2.0,
                                generator=gen)
    return (t * scale).to(dtype)


def dense(gen: torch.Generator, d_in: int, d_out, *, bias: bool = False,
          dtype=torch.float32, scale: float | None = None) -> dict:
    """Linear layer params (in, *out); d_out may be a tuple for
    multi-dim outputs."""
    out_dims = d_out if isinstance(d_out, tuple) else (d_out,)
    if scale is None:
        scale = 1.0 / math.sqrt(d_in)
    params = {"w": truncated_normal(gen, (d_in, *out_dims), scale, dtype)}
    if bias:
        params["b"] = torch.zeros(out_dims, dtype=dtype, device=gen.device)
    return params


def norm(d: int, kind: str, dtype=torch.float32, device="cpu") -> dict:
    if kind == "rmsnorm":
        return {"scale": torch.ones(d, dtype=dtype, device=device)}
    if kind == "layernorm":
        return {"scale": torch.ones(d, dtype=dtype, device=device),
                "bias": torch.zeros(d, dtype=dtype, device=device)}
    raise ValueError(kind)


def embedding(gen: torch.Generator, vocab: int, d: int,
              dtype=torch.float32) -> dict:
    return {"table": truncated_normal(gen, (vocab, d), 1.0, dtype)}


# ---- axes trees: the params trees above with a tuple of logical axis
# names (sharding.rules.LOGICAL_AXES) for each leaf, one name per dim ----
def dense_axes(axes: tuple, *, bias: bool = False) -> dict:
    out = {"w": axes}
    if bias:
        out["b"] = axes[1:]
    return out


def norm_axes(kind: str) -> dict:
    if kind == "rmsnorm":
        return {"scale": ("embed",)}
    return {"scale": ("embed",), "bias": ("embed",)}


def embedding_axes() -> dict:
    return {"table": ("vocab", "embed")}


def stack_axes(axes_tree):
    """Prefix every axes leaf with the scanned 'stack' dim."""
    if isinstance(axes_tree, dict):
        return {k: stack_axes(v) for k, v in axes_tree.items()}
    return ("stack", *axes_tree)
