"""Plain PyTorch versions of the RG-LRU scan kernel (K4).

The recurrence h_t = exp(log_a_t) * h_{t-1} + b_t over (B,S,W), in two
forms:

- ``rglru_scan_ref`` (``repro.kernels.rglru_scan.ref``): the sequential
  form, a loop over S carrying float32, the oracle the CUDA kernel is
  held to and the path a CPU tensor takes through ``ops.rglru_scan``;
- ``rglru_scan_assoc`` (``repro.models.rglru.rglru_scan_assoc``): the
  model's parallel form, the plain path of the RG-LRU block
  (``impl="dense"``).
"""

from __future__ import annotations

import torch


def rglru_scan_ref(log_a, b, h0):
    """h_t = exp(log_a_t) * h_{t-1} + b_t, one step at a time.

    log_a, b: (B,S,W); h0: (B,W).  Computes in float32 (a product, then a
    sum, each rounded) and returns h (B,S,W) in log_a's dtype."""
    la = log_a.to(torch.float32)
    bb = b.to(torch.float32)
    h = h0.to(torch.float32)
    hs = []
    for t in range(la.shape[1]):
        h = torch.exp(la[:, t]) * h + bb[:, t]
        hs.append(h)
    return torch.stack(hs, dim=1).to(log_a.dtype)


def rglru_scan_assoc(log_a, b, h0=None):
    """h_t = exp(log_a_t) * h_{t-1} + b_t as a parallel prefix over S.

    The reference's ``jax.lax.associative_scan`` of the pair operator
    (la1, b1) . (la2, b2) = (la1 + la2, exp(la2) b1 + b2), written as a
    doubling (Hillis-Steele) scan: ceil(log2 S) vectorised steps, where
    step d combines each position t >= d with the partial result at
    t - d.  Position t thus sums its terms in a binary tree over the
    offsets 1, 2, 4, ...; XLA's associative_scan takes an odd/even
    recursion instead, so the two round differently (within the
    reference's 1e-4 / 1e-5 of tests/test_recurrent.py).  Computes in the
    inputs' dtype, as the reference; h0 (B,W) is folded into the first
    step."""
    if h0 is not None:
        first = (b[:, 0] + torch.exp(log_a[:, 0]) * h0).to(b.dtype)
        b = torch.cat([first[:, None], b[:, 1:]], dim=1)
    la, h = log_a, b
    d = 1
    while d < la.shape[1]:
        h = torch.cat([h[:, :d], torch.exp(la[:, d:]) * h[:, :-d]
                       + h[:, d:]], dim=1)
        la = torch.cat([la[:, :d], la[:, d:] + la[:, :-d]], dim=1)
        d *= 2
    return h
