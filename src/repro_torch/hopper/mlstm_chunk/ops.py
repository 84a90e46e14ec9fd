"""The mLSTM chunk wrapper (K3) in the model's (B,S,H,dh) layout.

Replaces ``repro.kernels.mlstm_chunk.ops.mlstm_chunk``.  The forward is
the kernel; the backward differentiates the plain version
(``ref.mlstm_chunkwise`` at the reference kernel's chunk of 128), as the
reference's custom VJP does (the JAX package has no backward kernel).

Dispatch is by the tensors' device: a CPU tensor takes the plain version
(``ref.py``, in the same layout), a CUDA tensor launches the Hopper
kernel (``kernel.py``) or raises, through the custom op
``repro_torch::mlstm_chunk``, which a fake tensor (``FakeTensorMode``)
also takes: its fake registration gives the output's shape and dtype and
its flop formula counts the chunkwise form's operations at the
reference's chunk of 128 (``hopper.dispatch``).  There is no fallback
from the kernel to the plain version.  A ``meta`` tensor (shapes only, no data) goes
through the plain version's shapes; nothing is launched.  The wrapper
carries the telemetry probe (``kernel.mlstm_chunk.*``,
``repro_torch.telemetry.kernels``).
"""

from __future__ import annotations

import torch

from repro_torch.hopper.dispatch import kernel_op, takes_kernel_op
from repro_torch.hopper.mlstm_chunk import kernel
from repro_torch.hopper.mlstm_chunk.ref import KERNEL_CHUNK, mlstm_chunkwise
from repro_torch.hopper.tma import kernel_layout
from repro_torch.telemetry.kernels import kernel_probe


def _check(q, k, v, li, lf):
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"want q, k, v (B,S,H,dh) of one shape; got q "
                         f"{tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)}")
    if li.shape != q.shape[:3] or lf.shape != q.shape[:3]:
        raise ValueError(f"want li, lf (B,S,H) = {tuple(q.shape[:3])}; got "
                         f"{tuple(li.shape)}, {tuple(lf.shape)}")
    if q.shape[1] < 1:
        raise ValueError("the mLSTM needs at least one position")
    if q.dtype not in kernel.DTYPES:
        raise TypeError(f"the mLSTM chunk takes float32 or bfloat16 q, k, "
                        f"v; got {q.dtype}")
    for name, t in (("k", k), ("v", v)):
        if t.dtype != q.dtype:
            raise TypeError(f"{name} is {t.dtype}, q is {q.dtype}")
    for name, t in (("li", li), ("lf", lf)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32 (the reference's "
                            f"gates), got {t.dtype}")
    for name, t in (("k", k), ("v", v), ("li", li), ("lf", lf)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    if q.device.type == "cuda" and q.shape[3] > kernel.MAX_HEAD_DIM:
        raise ValueError(f"head_dim {q.shape[3]} is not taken by the "
                         f"kernel: at most {kernel.MAX_HEAD_DIM}")


def _plain(q, k, v, li, lf):
    return mlstm_chunkwise(q, k, v, li, lf, chunk=KERNEL_CHUNK)[0]


def _launch(q, k, v, li, lf):
    # the last dimension contiguous and, in bf16, the layout K2's TMA
    # tensor maps read (the same rule)
    q, k, v = (kernel_layout(t) for t in (q, k, v))
    return kernel.mlstm_chunk_cuda(q, k, v, li, lf)


def _flops(q, k, v, li, lf):
    """Per (b, h, chunk of l rows): 2 dh l(l+1) for the causal QK^T and
    (S.D)V, 4 l dh^2 for QC and K^T V (PERF.md §6)."""
    b, s, h, dh = q
    lens = [min(KERNEL_CHUNK, s - c) for c in range(0, s, KERNEL_CHUNK)]
    return b * h * sum(2 * dh * n * (n + 1) + 4 * n * dh * dh for n in lens)


_op = kernel_op("mlstm_chunk", "(Tensor q, Tensor k, Tensor v, Tensor li, "
                "Tensor lf) -> Tensor", _launch,
                lambda q, k, v, li, lf: torch.empty(q.shape, dtype=q.dtype,
                                                    device=q.device), _flops)


def _forward(q, k, v, li, lf):
    if takes_kernel_op(q):
        return _op(q, k, v, li, lf)
    if q.device.type in ("cpu", "meta"):
        return _plain(q, k, v, li, lf)
    raise ValueError(f"no mLSTM chunk kernel for device {q.device}")


class _MlstmChunk(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, li, lf):
        ctx.save_for_backward(q, k, v, li, lf)
        return _forward(q, k, v, li, lf)

    @staticmethod
    def backward(ctx, g):
        leaves = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad():
            return torch.autograd.grad(_plain(*leaves), leaves, g)


def mlstm_chunk(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                li: torch.Tensor, lf: torch.Tensor) -> torch.Tensor:
    """q, k, v: (B,S,H,dh); li, lf: (B,S,H) float32 log input/forget
    gates — the model's layout.  Returns h (B,S,H,dh) in q's dtype."""
    _check(q, k, v, li, lf)
    probe = kernel_probe("mlstm_chunk")
    out = _MlstmChunk.apply(q, k, v, li, lf)
    if probe is not None:
        B, S, H, dh = q.shape
        # intra-chunk QK^T + PV (causal halves) at 2 FLOPs/MAC: the
        # reference's 2 B S^2 d over its leading (B, H)
        probe.finish(out, flops=2.0 * B * H * S * S * dh,
                     arrays=(q, k, v, li, lf))
    return out
