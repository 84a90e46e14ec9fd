"""Which bfloat16 layouts the Hopper kernels' TMA tensor maps read in place.

K2 (flash attention) and K3 (mLSTM chunk) describe their bf16 (B, S,
heads, d) inputs by 4-D tensor maps over the caller's strides; this is
the one rule both wrappers apply before a launch.
"""

from __future__ import annotations

import torch


def tma_layout_ok(shape, strides) -> bool:
    """Whether a bfloat16 (B, S, heads, d) tensor with these strides (in
    elements) can be described by a TMA tensor map in place: 16-byte
    aligned strides, and each dimension of more than one element stepping
    over all of the dimensions inside it (heads over d, rows over heads,
    batches over rows), as the tensor map nests them.  Contiguous tensors
    and slices of a fused projection pass; a head-major tensor seen
    through a transpose does not."""
    if strides[-1] != 1 or any(st % 8 for st in strides[:3]):
        return False
    inner = shape[3]
    for dim in (2, 1, 0):
        if shape[dim] > 1:
            if strides[dim] < inner:
                return False
            inner = strides[dim] * shape[dim]
    return True


def kernel_layout(t):
    """``t`` as the kernels read it: rows of d through strides, so the
    last dimension contiguous and, in bfloat16, 16-byte aligned rows laid
    out as the TMA tensor maps describe them (``tma_layout_ok``); else a
    contiguous copy."""
    if t.stride(-1) != 1:
        return t.contiguous()
    if t.dtype == torch.bfloat16 and (
            t.data_ptr() % 16 or not tma_layout_ok(t.shape, t.stride())):
        return t.contiguous()
    return t
