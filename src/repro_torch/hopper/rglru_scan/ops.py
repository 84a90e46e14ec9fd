"""The RG-LRU scan wrapper (K4).

Replaces ``repro.kernels.rglru_scan.ops.rglru_scan``.  The forward is the
kernel; the backward differentiates the plain sequential version
(``ref.rglru_scan_ref``), as the reference's custom VJP does (the JAX
package has no backward kernel).

Dispatch is by the tensors' device: a CPU tensor takes the plain version
(``ref.py``), a CUDA tensor launches the Hopper kernel (``kernel.py``) or
raises, through the custom op ``repro_torch::rglru_scan``, which a fake
tensor (``FakeTensorMode``) also takes: its fake registration gives the
output's shape and dtype and its flop formula counts 3 operations an
element (``hopper.dispatch``).  There is no fallback from the kernel to
the plain version.  A
``meta`` tensor (shapes only, no data) goes through the plain version's
shapes; nothing is launched.  The wrapper carries the telemetry probe
(``kernel.rglru_scan.*``, ``repro_torch.telemetry.kernels``).
"""

from __future__ import annotations

import torch

from repro_torch.hopper.dispatch import kernel_op, takes_kernel_op
from repro_torch.hopper.rglru_scan import kernel
from repro_torch.hopper.rglru_scan.ref import rglru_scan_ref
from repro_torch.telemetry.kernels import kernel_probe


def _check(log_a, b, h0):
    if log_a.dim() != 3 or b.shape != log_a.shape:
        raise ValueError(f"want log_a and b (B,S,W) of one shape; got "
                         f"log_a {tuple(log_a.shape)}, b {tuple(b.shape)}")
    bsz, s, w = log_a.shape
    if h0.shape != (bsz, w):
        raise ValueError(f"want h0 (B,W) = {(bsz, w)}; got "
                         f"{tuple(h0.shape)}")
    if s < 1 or w < 1:
        raise ValueError("the RG-LRU scan needs at least one step and one "
                         "channel")
    for name, t in (("log_a", log_a), ("b", b)):
        if t.dtype not in kernel.DTYPES:
            raise TypeError(f"the RG-LRU scan takes float32 or bfloat16 "
                            f"{name}; got {t.dtype}")
    if h0.dtype != torch.float32:
        raise TypeError(f"h0 must be float32 (the reference's carry), got "
                        f"{h0.dtype}")
    for name, t in (("b", b), ("h0", h0)):
        if t.device != log_a.device:
            raise ValueError(f"{name} is on {t.device}, log_a on "
                             f"{log_a.device}")


def _launch(log_a, b, h0):
    log_a, b, h0 = (t if t.stride(-1) == 1 else t.contiguous()
                    for t in (log_a, b, h0))
    return kernel.rglru_scan_cuda(log_a, b, h0)


def _flops(log_a, b, h0):
    """exp, multiply, add: 3 an element (PERF.md §6)."""
    return 3 * log_a[0] * log_a[1] * log_a[2]


_op = kernel_op("rglru_scan", "(Tensor log_a, Tensor b, Tensor h0) -> "
                "Tensor", _launch,
                lambda log_a, b, h0: torch.empty(log_a.shape,
                                                 dtype=log_a.dtype,
                                                 device=log_a.device),
                _flops)


def _forward(log_a, b, h0):
    if takes_kernel_op(log_a):
        return _op(log_a, b, h0)
    if log_a.device.type in ("cpu", "meta"):
        return rglru_scan_ref(log_a, b, h0)
    raise ValueError(f"no RG-LRU scan kernel for device {log_a.device}")


class _RglruScan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, log_a, b, h0):
        ctx.save_for_backward(log_a, b, h0)
        return _forward(log_a, b, h0)

    @staticmethod
    def backward(ctx, g):
        leaves = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad():
            return torch.autograd.grad(rglru_scan_ref(*leaves), leaves, g)


def rglru_scan(log_a: torch.Tensor, b: torch.Tensor,
               h0: torch.Tensor) -> torch.Tensor:
    """log_a, b: (B,S,W) float32 or bfloat16; h0: (B,W) float32.  Returns
    h (B,S,W) in log_a's dtype, h_t = exp(log_a_t) h_{t-1} + b_t."""
    _check(log_a, b, h0)
    probe = kernel_probe("rglru_scan")
    out = _RglruScan.apply(log_a, b, h0)
    if probe is not None:
        # exp + multiply-accumulate per element of the scanned sequence
        probe.finish(out, flops=3.0 * log_a.numel(), arrays=(log_a, b, h0))
    return out
