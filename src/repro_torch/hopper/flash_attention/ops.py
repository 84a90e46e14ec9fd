"""The flash attention wrapper (K2) in the model's (B,S,H,d) layout.

Replaces ``repro.kernels.flash_attention.ops.flash_attention``.  The
forward is the kernel; the backward recomputes attention through the
port's dense path (``models.attention.dense_attention``) and
differentiates that, as the reference's custom VJP does (the JAX package
has no backward kernel).  Up to ``DENSE_MAX_SEQ`` tokens the recompute is
whole; above it, as the reference switches to its chunked and banded
paths, it goes by query blocks of ``Q_CHUNK`` rows, each over only the
keys its rows can see, so it never holds (B, H, S, S) logits.

Dispatch is by the tensors' device: a CPU tensor takes the plain version
(``ref.py``, head-major, so the CPU path transposes around it), a CUDA
tensor launches the Hopper kernel (``kernel.py``) or raises, through the
custom op ``repro_torch::flash_attention``, which a fake tensor
(``FakeTensorMode``, the dry run) also takes: its fake registration gives
the output's shape and dtype and its flop formula counts the pairs K2
computes (the causal half, the window's band; ``hopper.dispatch``).
There is no fallback from the kernel to the plain version.  A ``meta``
tensor (shapes only, no data) goes through the plain version's shapes;
nothing is launched.  The wrapper carries the telemetry probe
(``kernel.flash_attention.*``, ``repro_torch.telemetry.kernels``).
"""

from __future__ import annotations

import torch

from repro_torch.hopper.dispatch import kernel_op, takes_kernel_op
from repro_torch.hopper.flash_attention import kernel
from repro_torch.hopper.flash_attention.ref import attention_ref
from repro_torch.hopper.tma import kernel_layout
from repro_torch.telemetry.kernels import kernel_probe


def _check(q, k, v, window):
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"want q (B,S,H,d) and k, v (B,S,KVH,d); got q "
                         f"{tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)}")
    b, s, h, d = q.shape
    if k.shape[:2] != (b, s) or k.shape[3] != d or h % k.shape[2]:
        raise ValueError(f"k, v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)} (heads must be a multiple of "
                         f"kv heads)")
    if q.dtype not in kernel.DTYPES:
        raise TypeError(f"flash attention takes float32 or bfloat16, got "
                        f"{q.dtype}")
    for name, t in (("k", k), ("v", v)):
        if t.dtype != q.dtype:
            raise TypeError(f"{name} is {t.dtype}, q is {q.dtype}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    if d > kernel.MAX_HEAD_DIM or (q.dtype == torch.bfloat16 and d % 16):
        raise ValueError(f"head_dim {d} is not taken by the kernel: at most "
                         f"{kernel.MAX_HEAD_DIM}, a multiple of 16 in "
                         f"bfloat16")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")


def attention_pairs(s: int, causal: bool, window: int) -> int:
    """The (query, key) pairs K2 computes at length ``s``: each query's
    keys from the window's left edge (0 without one) to itself (the end
    without causality)."""
    if causal:
        if not window or s <= window:
            return s * (s + 1) // 2
        return window * (window + 1) // 2 + (s - window) * window
    if not window or s <= window:
        return s * s
    return s * s - (s - window) * (s - window + 1) // 2


def _launch(q, k, v, causal, window, softcap):
    return kernel.flash_attention_cuda(
        kernel_layout(q), kernel_layout(k), kernel_layout(v),
        causal=causal, window=window, softcap=softcap)


def _fake(q, k, v, causal, window, softcap):
    return torch.empty(q.shape, dtype=q.dtype, device=q.device)


def _flops(q, k, v, causal, window, softcap):
    """2 d flops a pair for QK^T and 2 d for PV (PERF.md §6)."""
    b, s, h, d = q
    return 4 * d * attention_pairs(s, causal, window) * b * h


_op = kernel_op("flash_attention", "(Tensor q, Tensor k, Tensor v, bool "
                "causal, int window, float softcap) -> Tensor", _launch,
                _fake, _flops)


def _forward(q, k, v, causal, window, softcap):
    if takes_kernel_op(q):
        return _op(q, k, v, causal, window, softcap)
    if q.device.type in ("cpu", "meta"):
        out = attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2), causal=causal, window=window,
                            softcap=softcap)
        return out.transpose(1, 2).contiguous()
    raise ValueError(f"no flash attention kernel for device {q.device}")


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap):
        ctx.save_for_backward(q, k, v)
        ctx.mask = (causal, window, softcap)
        return _forward(q, k, v, causal, window, softcap)

    @staticmethod
    def backward(ctx, g):
        from repro_torch.models import attention
        causal, window, softcap = ctx.mask
        q, k, v = ctx.saved_tensors
        if q.shape[1] > attention.DENSE_MAX_SEQ:
            grads = _blocked_grads(q, k, v, g, causal, window, softcap,
                                   attention.Q_CHUNK)
            return (*grads, None, None, None)
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        with torch.enable_grad():
            out = attention.dense_attention(*leaves, causal=causal,
                                            window=window, softcap=softcap)
            grads = torch.autograd.grad(out, leaves, g)
        return (*grads, None, None, None)


def _blocked_grads(q, k, v, g, causal, window, softcap, chunk):
    """The dense recompute's gradients, one block of ``chunk`` query rows
    at a time: the block's rows see keys [lo, hi), from the window's left
    edge of its first row (0 without a window) to its last row (S without
    causality), so ``q_offset`` = i0 - lo places both in the block's
    frame.  dq is written a block at a time; dk and dv add up in float32
    over the blocks (the leaves are float32 copies, as dense_attention
    computes in float32), then take the inputs' dtypes once."""
    from repro_torch.models.attention import dense_attention
    s = q.shape[1]
    f32 = torch.float32
    dq = torch.empty_like(q)
    dk = torch.zeros(k.shape, dtype=f32, device=k.device)
    dv = torch.zeros(v.shape, dtype=f32, device=v.device)
    for i0 in range(0, s, chunk):
        i1 = min(i0 + chunk, s)
        lo = max(0, i0 - window + 1) if window else 0
        hi = i1 if causal else s
        leaves = [q[:, i0:i1].to(f32).requires_grad_(),
                  k[:, lo:hi].to(f32).requires_grad_(),
                  v[:, lo:hi].to(f32).requires_grad_()]
        with torch.enable_grad():
            out = dense_attention(*leaves, causal=causal, window=window,
                                  softcap=softcap, q_offset=i0 - lo)
            gq, gk, gv = torch.autograd.grad(out, leaves,
                                             g[:, i0:i1].to(f32))
        dq[:, i0:i1] = gq
        dk[:, lo:hi] += gk
        dv[:, lo:hi] += gv
        del leaves, out, gq, gk, gv
    return dq, dk.to(k.dtype), dv.to(v.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int = 0,
                    softcap: float = 0.0) -> torch.Tensor:
    """q: (B,S,H,d); k,v: (B,S,KVH,d) — the model-zoo layout.  Returns
    (B,S,H,d) in q's dtype."""
    _check(q, k, v, window)
    probe = kernel_probe("flash_attention")
    out = _FlashAttention.apply(q, k, v, causal, window, softcap)
    if probe is not None:
        B, S, H, d = q.shape
        kv = min(window, S) if window else S
        # QK^T and PV matmuls, 2 FLOPs/MAC; causal halves the rectangle
        flops = 4.0 * B * H * S * kv * d * (0.5 if causal and not window
                                            else 1.0)
        probe.finish(out, flops=flops, arrays=(q, k, v))
    return out
