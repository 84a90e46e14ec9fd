"""Parameter-creation helpers (``repro.models.init_utils``, the part the
CNN needs)."""

from __future__ import annotations

import torch


def truncated_normal(gen: torch.Generator, shape, scale,
                     dtype=torch.float32) -> torch.Tensor:
    """A standard normal truncated to [-2, 2], times ``scale``, drawn from
    ``gen`` in float32 (the reference's ``truncated_normal``).  The draw
    happens on ``gen``'s device."""
    t = torch.empty(shape, dtype=torch.float32, device=gen.device)
    torch.nn.init.trunc_normal_(t, mean=0.0, std=1.0, a=-2.0, b=2.0,
                                generator=gen)
    return (t * scale).to(dtype)
