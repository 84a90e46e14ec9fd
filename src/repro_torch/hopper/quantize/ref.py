"""Plain PyTorch version of the quantize-dequantize kernel (K1).

The oracle the CUDA kernel is held to (bit for bit), and the path a CPU
tensor takes.  Stochastic rounding is ``floor(x/scale + u)`` with
``u ~ U[0, 1)``: it rounds up with probability equal to the fractional
part, so the quantizer is unbiased away from the clip boundary; a constant
``u = 0.5`` is round-half-up (deterministic mode).  The multiply and the
add are separate operations, as in ``repro.kernels.quantize.ref``.
"""

from __future__ import annotations

import torch


def quantize_dequantize_ref(x: torch.Tensor, u: torch.Tensor,
                            scale: torch.Tensor, qmax: int) -> torch.Tensor:
    """Fake-quantize each row of ``x`` to the grid [-qmax, qmax] * scale.

    x, u: (R, n); scale: (R,) per-row step size (absmax / qmax).  Returns
    x_hat with x's dtype."""
    s = scale.to(torch.float32)[:, None]
    inv = torch.where(s > 0, 1.0 / s, torch.zeros_like(s))
    q = torch.floor(x.to(torch.float32) * inv + u.to(torch.float32))
    q = torch.clamp(q, -float(qmax), float(qmax))
    return (q * s).to(x.dtype)
