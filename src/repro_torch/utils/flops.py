"""Analytical FLOP accounting (the reference's ``repro.utils.flops``)."""

from __future__ import annotations


def matmul_flops(m: int, k: int, n: int) -> int:
    """FLOPs of an (m,k) @ (k,n) matmul (multiply-adds counted as 2)."""
    return 2 * m * k * n


def dense_model_flops(num_params: int, num_tokens: int) -> int:
    """The standard 6*N*D training-FLOPs estimate (fwd 2ND + bwd 4ND)."""
    return 6 * num_params * num_tokens


def forward_model_flops(num_params: int, num_tokens: int) -> int:
    """2*N*D forward-only estimate (prefill / decode)."""
    return 2 * num_params * num_tokens


def attention_flops(batch: int, q_len: int, kv_len: int, num_heads: int,
                    head_dim: int, *, backward: bool = False) -> int:
    """QK^T + AV flops for (possibly rectangular) attention."""
    f = 2 * batch * num_heads * q_len * kv_len * head_dim * 2  # qk and av
    return f * 3 if backward else f


def conv2d_flops(batch: int, out_h: int, out_w: int, kernel: int,
                 cin: int, cout: int) -> int:
    """FLOPs of one 2-D convolution producing a (batch, out_h, out_w, cout)
    map from a kernel x kernel window over cin channels (multiply-adds as 2).
    The weights are reused at every output position, so this is NOT
    2 * params * batch."""
    return 2 * batch * out_h * out_w * kernel * kernel * cin * cout


def dense_layer_flops(batch: int, din: int, dout: int) -> int:
    """Forward FLOPs of a (batch, din) @ (din, dout) dense layer."""
    return matmul_flops(batch, din, dout)


def training_flops(forward_flops: int) -> int:
    """fwd + bwd at the standard 1:2 ratio (same rule as the 6ND estimate:
    2ND forward, 4ND backward)."""
    return 3 * forward_flops
