"""The flash attention wrapper (K2) in the model's (B,S,H,d) layout.

Replaces ``repro.kernels.flash_attention.ops.flash_attention``.  The
forward is the kernel; the backward recomputes attention through the
port's dense path (``models.attention.dense_attention``) and
differentiates that, as the reference's custom VJP does (the JAX package
has no backward kernel).  The reference switches that recompute to its
chunked path above 4096 tokens; the port has no chunked path yet, so its
backward is dense at every length.

Dispatch is by the tensors' device: a CPU tensor takes the plain version
(``ref.py``, head-major, so the CPU path transposes around it), a CUDA
tensor launches the Hopper kernel (``kernel.py``) or raises.  There is no
fallback from the kernel to the plain version.
"""

from __future__ import annotations

import torch

from repro_torch.hopper.flash_attention import kernel
from repro_torch.hopper.flash_attention.ref import attention_ref


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


def tma_layout_ok(shape, strides) -> bool:
    """Whether a bfloat16 (B, S, heads, d) tensor with these strides (in
    elements) can be described by the kernel's TMA tensor map in place:
    16-byte aligned strides, and each dimension of more than one element
    stepping over all of the dimensions inside it (heads over d, rows
    over heads, batches over rows), as the tensor map nests them.
    Contiguous tensors and slices of a fused projection pass; a
    head-major tensor seen through a transpose does not."""
    if strides[-1] != 1 or any(st % 8 for st in strides[:3]):
        return False
    inner = shape[3]
    for dim in (2, 1, 0):
        if shape[dim] > 1:
            if strides[dim] < inner:
                return False
            inner = strides[dim] * shape[dim]
    return True


def _kernel_layout(t):
    """The kernel reads rows of d through strides; it needs the last
    dimension contiguous and, in bfloat16, 16-byte aligned rows laid out
    as its TMA tensor maps describe them (``tma_layout_ok``)."""
    if t.stride(-1) != 1:
        return t.contiguous()
    if t.dtype == torch.bfloat16 and (
            t.data_ptr() % 16 or not tma_layout_ok(t.shape, t.stride())):
        return t.contiguous()
    return t


def _forward(q, k, v, causal, window, softcap):
    if q.device.type == "cpu":
        out = attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2), causal=causal, window=window,
                            softcap=softcap)
        return out.transpose(1, 2).contiguous()
    if q.device.type == "cuda":
        return kernel.flash_attention_cuda(
            _kernel_layout(q), _kernel_layout(k), _kernel_layout(v),
            causal=causal, window=window, softcap=softcap)
    raise ValueError(f"no flash attention kernel for device {q.device}")


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap):
        ctx.save_for_backward(q, k, v)
        ctx.mask = (causal, window, softcap)
        return _forward(q, k, v, causal, window, softcap)

    @staticmethod
    def backward(ctx, g):
        from repro_torch.models.attention import dense_attention
        causal, window, softcap = ctx.mask
        leaves = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad():
            out = dense_attention(*leaves, causal=causal, window=window,
                                  softcap=softcap)
            grads = torch.autograd.grad(out, leaves, g)
        return (*grads, None, None, None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int = 0,
                    softcap: float = 0.0) -> torch.Tensor:
    """q: (B,S,H,d); k,v: (B,S,KVH,d) — the model-zoo layout.  Returns
    (B,S,H,d) in q's dtype."""
    _check(q, k, v, window)
    return _FlashAttention.apply(q, k, v, causal, window, softcap)
