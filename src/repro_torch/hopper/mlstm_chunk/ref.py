"""Plain PyTorch versions of the mLSTM chunk kernel (K3).

The oracle the CUDA kernel is held to, and the path a CPU tensor takes
(``repro.kernels.mlstm_chunk.ref``): the chunkwise-parallel form
``mlstm_chunkwise`` in the model's (B,S,H,dh) layout (the model's own
plain path, ``repro.models.xlstm.mlstm_chunkwise``), ``mlstm_ref``, the
same re-laid-out to head-major, and the O(1) recurrent step
``mlstm_step`` (the model's decode step) with ``mlstm_recurrent_ref``,
the step-by-step oracle and ground truth for both forms.  Beside them,
``mlstm_three_pass``, a plain emulation of the bf16 CUDA kernel's scheme
(gates, then the chunk-boundary states, then the outputs, with the
kernel's bf16 hi/lo splits), which only the tests use: it shows the
scheme's numerics on the CPU.
"""

from __future__ import annotations

import torch

MLSTM_CHUNK = 256          # the model's chunk (repro.models.xlstm)
KERNEL_CHUNK = 128         # the reference kernel's chunk (mlstm_ref)
STATE_CHUNK = 256          # the bf16 kernel's state chunk (the .cu's kChunk)
TILE = 64                  # the bf16 kernel's query and key tiles
NEG_BIG = -1e30


def mlstm_chunkwise(q, k, v, li, lf, carry=None, chunk: int = MLSTM_CHUNK):
    """Chunkwise-parallel stabilized mLSTM (the plain version of K3).

    q,k,v: (B,S,H,dh); li,lf: (B,S,H) input/forget log-gates.
    carry: optional (C (B,H,dk,dv), n (B,H,dk), m (B,H)).
    Returns (h (B,S,H,dh) in q's dtype, carry')."""
    b, s, h, dh = q.shape
    if s % chunk:      # fall back to one chunk: the quadratic path
        chunk = s
    nc = s // chunk
    f32 = torch.float32
    qc = q.reshape(b, nc, chunk, h, dh).to(f32)
    kc = k.reshape(b, nc, chunk, h, dh).to(f32)
    vc = v.reshape(b, nc, chunk, h, dh).to(f32)
    lic = li.reshape(b, nc, chunk, h).to(f32)
    lfc = lf.reshape(b, nc, chunk, h).to(f32)
    if carry is None:
        C = q.new_zeros((b, h, dh, dh), dtype=f32)
        n = q.new_zeros((b, h, dh), dtype=f32)
        m_prev = q.new_full((b, h), NEG_BIG, dtype=f32)
    else:
        C, n, m_prev = (c.to(f32) for c in carry)
    t_idx = torch.arange(chunk, device=q.device)
    causal = (t_idx[None, :, None, None] >= t_idx[None, None, :, None])
    hs = []
    for c in range(nc):
        qb, kb, vb, lib, lfb = (t[:, c] for t in (qc, kc, vc, lic, lfc))
        a = torch.cumsum(lfb, dim=1)                       # (B,chunk,H)
        g = lib - a                                        # g_s = li_s - a_s
        run_max = torch.cummax(g, dim=1).values
        M = torch.maximum(m_prev[:, None, :], run_max)     # (B,chunk,H)
        m_t = a + M
        # intra-chunk: D[t,s] = exp(g_s - M_t) for s <= t.  The masked
        # half (s > t) may overflow: the reference selects after the exp,
        # and its VJP then takes 0 x inf = NaN (R4); selecting -inf before
        # the exp gives the same D and a finite gradient
        Dlog = g[:, None, :, :] - M[:, :, None, :]         # (B,t,s,H)
        D = torch.exp(torch.where(causal, Dlog, float("-inf")))
        scores = torch.einsum("bthd,bshd->btsh", qb, kb) * D
        h_intra = torch.einsum("btsh,bshd->bthd", scores, vb)
        n_intra = torch.einsum("btsh,bshd->bthd", D, kb)
        # inter-chunk carry contribution, decayed by exp(m_prev - M_t)
        decay = torch.exp(m_prev[:, None, :] - M)          # (B,chunk,H)
        h_inter = torch.einsum("bthd,bhde->bthe", qb, C) * decay[..., None]
        n_inter = n[:, None, :, :] * decay[..., None]
        n_tot = n_intra + n_inter
        denom = torch.maximum(
            torch.einsum("bthd,bthd->bth", qb, n_tot).abs(),
            torch.exp(-m_t))[..., None]
        hs.append((h_intra + h_inter) / denom)
        # ---- end-of-chunk carry update ----
        M_L = M[:, -1, :]
        m_new = m_t[:, -1, :]
        w_s = torch.exp(g - M_L[:, None, :])               # (B,chunk,H)
        f_L = torch.exp(m_prev - M_L)
        C = C * f_L[:, :, None, None] + torch.einsum(
            "bsh,bshd,bshe->bhde", w_s, kb, vb)
        n = n * f_L[:, :, None] + torch.einsum("bsh,bshd->bhd", w_s, kb)
        m_prev = m_new
    h_all = torch.stack(hs, dim=1).reshape(b, s, h, dh)
    return h_all.to(q.dtype), (C, n, m_prev)


def mlstm_step(q, k, v, li, lf, carry):
    """O(1) recurrent decode step.  q,k,v: (B,1,H,dh); li,lf: (B,1,H).

    Updates the carry (C, n, m) **in place** and returns (h (B,1,H,dh),
    carry).  Computes in the carry's dtype (float32 in the model)."""
    C, n, m_prev = carry
    ct = C.dtype
    qs, ks, vs = (t[:, 0].to(ct) for t in (q, k, v))
    lis, lfs = li[:, 0].to(ct), lf[:, 0].to(ct)
    m_new = torch.maximum(lfs + m_prev, lis)
    fgate = torch.exp(lfs + m_prev - m_new)[..., None]
    igate = torch.exp(lis - m_new)[..., None]
    C.mul_(fgate[..., None]).add_(
        igate[..., None] * ks[..., :, None] * vs[..., None, :])
    n.mul_(fgate).add_(igate * ks)
    m_prev.copy_(m_new)
    hh = torch.einsum("bhd,bhde->bhe", qs, C)
    denom = torch.maximum(torch.einsum("bhd,bhd->bh", qs, n).abs(),
                          torch.exp(-m_new))[..., None]
    return (hh / denom)[:, None].to(q.dtype), carry


def mlstm_ref(q, k, v, li, lf, chunk: int = KERNEL_CHUNK):
    """q,k,v: (B,H,S,dh); li,lf: (B,H,S) -> h (B,H,S,dh) in q's dtype."""
    h, _ = mlstm_chunkwise(q.transpose(1, 2), k.transpose(1, 2),
                           v.transpose(1, 2), li.transpose(1, 2),
                           lf.transpose(1, 2), chunk=chunk)
    return h.transpose(1, 2)


def mlstm_recurrent_ref(q, k, v, li, lf, dtype=torch.float32):
    """Step-by-step recurrent oracle.  Same layout as ``mlstm_ref``; the
    carry and the arithmetic in ``dtype`` (float64 inputs and dtype make
    the float64 witness the kernel's checks use at long ragged S)."""
    b, h, s, dh = q.shape
    carry = (q.new_zeros((b, h, dh, dh), dtype=dtype),
             q.new_zeros((b, h, dh), dtype=dtype),
             q.new_full((b, h), NEG_BIG, dtype=dtype))
    outs = []
    for t in range(s):
        ht, carry = mlstm_step(q[:, :, t][:, None], k[:, :, t][:, None],
                               v[:, :, t][:, None], li[:, :, t][:, None],
                               lf[:, :, t][:, None], carry)
        outs.append(ht[:, 0])
    return torch.stack(outs, dim=2)                        # (B,H,S,dh)


def _split(x):
    """x (float32) as bf16 hi + lo, each widened back: hi = bf16(x), lo =
    bf16(x - hi), together about 2^-17 relative."""
    hi = x.to(torch.bfloat16).to(torch.float32)
    return hi, (x - hi).to(torch.bfloat16).to(torch.float32)


def mlstm_three_pass(q, k, v, li, lf, state_chunk: int = STATE_CHUNK,
                     tile: int = TILE):
    """The bf16 kernel's scheme, step for step in plain PyTorch (tests
    only).  q,k,v: (B,S,H,dh); li,lf: (B,S,H) float32 -> h in q's dtype.

    1. gates: per chunk of ``state_chunk`` rows a, g, M, m, the decay
       exp(m_prev - M_t), exp(-m_t), w_s and f_L, in float32;
    2. states: C and n at each chunk boundary, C += K^T (wV_hi + wV_lo)
       summed in float32, stored as bf16 hi and lo planes;
    3. outputs: Q C_hi + Q C_lo and q . (n_hi + n_lo), scaled by the
       decay; then key tiles of ``tile`` up to the diagonal, P = (Q K^T) .
       D in float32, its row sums into the denominator, P_hi V + P_lo V;
       the output rounded once."""
    b, s, h, dh = q.shape
    f32 = torch.float32
    L = state_chunk
    nc = -(-s // L)
    out = torch.empty((b, s, h, dh), dtype=f32, device=q.device)
    for bi in range(b):
        for hi_ in range(h):
            qh, kh, vh = (t[bi, :, hi_].to(f32) for t in (q, k, v))
            lih, lfh = li[bi, :, hi_].to(f32), lf[bi, :, hi_].to(f32)
            m_prev = torch.tensor(NEG_BIG, dtype=f32, device=q.device)
            C = torch.zeros((dh, dh), dtype=f32, device=q.device)
            n = torch.zeros(dh, dtype=f32, device=q.device)
            planes = None                      # (C_hi, C_lo, n_hi, n_lo)
            for c in range(nc):
                r0, r1 = c * L, min(s, (c + 1) * L)
                a = torch.cumsum(lfh[r0:r1], 0)
                g = lih[r0:r1] - a
                M = torch.maximum(m_prev, torch.cummax(g, 0).values)
                m_t = a + M
                decay = torch.exp(m_prev - M)
                low = torch.exp(-m_t)
                qc, kc, vc = qh[r0:r1], kh[r0:r1], vh[r0:r1]
                rows = r1 - r0
                # -- outputs: the inter-chunk part from the stored planes
                if planes is None:
                    o = torch.zeros((rows, dh), dtype=f32, device=q.device)
                    qn = torch.zeros(rows, dtype=f32, device=q.device)
                else:
                    c_hi, c_lo, n_hi, n_lo = planes
                    o = (qc @ c_hi + qc @ c_lo) * decay[:, None]
                    qn = (qc @ n_hi + qc @ n_lo) * decay
                rsum = torch.zeros(rows, dtype=f32, device=q.device)
                for t0 in range(0, rows, tile):
                    t1 = min(rows, t0 + tile)
                    tpos = torch.arange(t0, t1, device=q.device)
                    for s0 in range(0, t1, tile):
                        s1 = min(rows, s0 + tile)
                        spos = torch.arange(s0, s1, device=q.device)
                        keep = spos[None, :] <= tpos[:, None]
                        dmat = torch.where(
                            keep, torch.exp(g[None, s0:s1]
                                            - M[t0:t1, None]), 0.0)
                        p = (qc[t0:t1] @ kc[s0:s1].T) * dmat
                        rsum[t0:t1] += p.sum(1)
                        p_hi, p_lo = _split(p)
                        o[t0:t1] += p_hi @ vc[s0:s1] + p_lo @ vc[s0:s1]
                den = torch.maximum((rsum + qn).abs(), low)
                out[bi, r0:r1, hi_] = o / den[:, None]
                # -- states: the boundary after this chunk (never after
                # the last, which no output reads)
                if c < nc - 1:
                    M_L = M[-1]
                    w = torch.exp(g - M_L)
                    f_L = torch.exp(m_prev - M_L)
                    wv_hi, wv_lo = _split(w[:, None] * vc)
                    C = C * f_L + (kc.T @ wv_hi + kc.T @ wv_lo)
                    n = n * f_L + kc.T @ w
                    planes = (*_split(C), *_split(n))
                    m_prev = m_t[-1]
    return out.to(q.dtype)
