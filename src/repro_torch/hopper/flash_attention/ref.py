"""Plain PyTorch version of the flash attention kernel (K2).

The oracle the CUDA kernel is held to, and the path a CPU tensor takes:
``repro.kernels.flash_attention.ref.attention_ref``, a dense masked
softmax in float32 over head-major q (B,H,S,d) and k, v (B,KVH,S,d),
masked with the finite NEG_INF = -2^30 and returned in q's dtype.
"""

from __future__ import annotations

import math

import torch

NEG_INF = -2.0 ** 30


def attention_ref(q, k, v, *, causal: bool = True, window: int = 0,
                  softcap: float = 0.0):
    """q: (B,H,S,d); k,v: (B,KVH,S,d).  Dense masked softmax reference."""
    b, h, s, d = q.shape
    g = h // k.shape[1]
    kx = k.repeat_interleave(g, dim=1)
    vx = v.repeat_interleave(g, dim=1)
    scale = 1.0 / math.sqrt(d)
    logits = torch.einsum("bhqd,bhkd->bhqk", q.to(torch.float32) * scale,
                          kx.to(torch.float32))
    if softcap:
        logits = torch.tanh(logits / softcap) * softcap
    pos = torch.arange(s, device=q.device)
    keep = torch.ones((s, s), dtype=torch.bool, device=q.device)
    if causal:
        keep &= pos[None, :] <= pos[:, None]
    if window:
        keep &= pos[None, :] > pos[:, None] - window
    logits = torch.where(keep, logits, torch.tensor(NEG_INF, device=q.device))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", probs, vx.to(torch.float32))
    return out.to(q.dtype)
