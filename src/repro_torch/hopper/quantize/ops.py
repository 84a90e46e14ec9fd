"""The quantize-dequantize wrapper (K1) with a straight-through gradient.

Replaces ``repro.kernels.quantize.ops`` on the PyTorch side.  What the
kernel does not: the per-row absmax scale (``tensor_scale``), drawing the
stochastic-rounding uniforms from a ``torch.Generator``, flattening any
shape to rows, and a straight-through estimator, so the fake quantizer is
transparent to autograd (its true derivative is 0 almost everywhere).

Dispatch is by the tensor's device: a CPU tensor takes the plain version
(``ref.py``), a CUDA tensor launches the Hopper kernel (``kernel.py``) or
raises, through the custom op ``repro_torch::quantize``, which a fake
tensor (``FakeTensorMode``) also takes: its fake registration gives the
output's shape and dtype and its flop formula counts 5 operations an
element (``hopper.dispatch``).  There is no fallback from the kernel to
the plain version.  A ``meta`` tensor (shapes only, no data) goes
through the plain version's shapes; nothing is launched.

``quantize_rows``, the codec entry, carries the telemetry probe
(``kernel.quantize.*``, ``repro_torch.telemetry.kernels``), as the
reference's ``quantize_dequantize`` does.
"""

from __future__ import annotations

import torch

from repro_torch.hopper.dispatch import kernel_op, takes_kernel_op
from repro_torch.hopper.quantize import kernel
from repro_torch.hopper.quantize.ref import quantize_dequantize_ref
from repro_torch.telemetry.kernels import kernel_probe


def tensor_scale(x: torch.Tensor, qmax: int) -> torch.Tensor:
    """Per-row symmetric step size of an (R, n) tensor: absmax / qmax, (R,)
    float32 (0 for an all-zero row)."""
    return x.to(torch.float32).abs().amax(dim=1) / qmax


def _check(x, u, scale):
    if x.dim() != 2:
        raise ValueError(f"x must be (rows, n), got shape {tuple(x.shape)}")
    if u.shape != x.shape or scale.shape != x.shape[:1]:
        raise ValueError(f"shapes x {tuple(x.shape)}, u {tuple(u.shape)}, "
                         f"scale {tuple(scale.shape)}: want u like x and "
                         f"scale (rows,)")
    for name, t in (("x", x), ("u", u), ("scale", scale)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _flops(x, u, scale, qmax):
    """scale, floor, add, clip, dequantize: 5 an element (PERF.md §6)."""
    return 5 * x[0] * x[1]


def _launch(x, u, scale, qmax):
    return kernel.quantize_dequantize_cuda(x, u, scale, qmax)


_op = kernel_op("quantize", "(Tensor x, Tensor u, Tensor scale, int qmax) "
                "-> Tensor", _launch,
                lambda x, u, scale, qmax: torch.empty_like(x), _flops)


def _forward(x, u, scale, qmax):
    if takes_kernel_op(x):
        return _op(x, u, scale, qmax)
    if x.device.type in ("cpu", "meta"):
        return quantize_dequantize_ref(x, u, scale, qmax)
    raise ValueError(f"no quantize kernel for device {x.device}")


class _QuantizeDequantizeSTE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, u, scale, qmax):
        return _forward(x, u, scale.detach(), qmax)

    @staticmethod
    def backward(ctx, g):
        # straight-through to x; nothing to the uniforms or the scale
        return g, None, None, None


def quantize_dequantize(x: torch.Tensor, u: torch.Tensor,
                        scale: torch.Tensor, qmax: int) -> torch.Tensor:
    """Fake-quantize (R, n) ``x`` row by row, with uniforms ``u`` (R, n) and
    step sizes ``scale`` (R,), all float32 and contiguous."""
    _check(x, u, scale)
    return _QuantizeDequantizeSTE.apply(x, u, scale, qmax)


def quantize_rows(x: torch.Tensor, generator: torch.Generator | None, *,
                  bits: int = 8, stochastic: bool = True) -> torch.Tensor:
    """The codec entry: fake-quantize each ``x[r]`` (any trailing shape) as
    one tensor with its own absmax scale, the reference's
    ``quantize_dequantize`` under ``vmap`` over the leading dimension.

    ``generator`` (on x's device) draws the stochastic-rounding uniforms;
    it is unused when ``stochastic=False``, which rounds half-up."""
    probe = kernel_probe("quantize")
    qmax = 2 ** (bits - 1) - 1
    x2 = x.reshape(x.shape[0], -1).contiguous()
    if stochastic:
        u = torch.rand(x2.shape, generator=generator, dtype=torch.float32,
                       device=x.device)
    else:
        u = torch.full(x2.shape, 0.5, dtype=torch.float32, device=x.device)
    out = quantize_dequantize(x2, u, tensor_scale(x2, qmax),
                              qmax).reshape(x.shape)
    if probe is not None:
        # scale + round + clip + dequant per element
        probe.finish(out, flops=4.0 * x.numel(), arrays=(x,))
    return out
