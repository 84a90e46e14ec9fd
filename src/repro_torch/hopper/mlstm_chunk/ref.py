"""Plain PyTorch versions of the mLSTM chunk kernel (K3).

The oracle the CUDA kernel is held to, and the path a CPU tensor takes
(``repro.kernels.mlstm_chunk.ref``): the chunkwise-parallel form
``mlstm_chunkwise`` in the model's (B,S,H,dh) layout (the model's own
plain path, ``repro.models.xlstm.mlstm_chunkwise``), ``mlstm_ref``, the
same re-laid-out to head-major, and the O(1) recurrent step
``mlstm_step`` (the model's decode step) with ``mlstm_recurrent_ref``,
the step-by-step oracle and ground truth for both forms.
"""

from __future__ import annotations

import torch

MLSTM_CHUNK = 256          # the model's chunk (repro.models.xlstm)
KERNEL_CHUNK = 128         # the reference kernel's chunk (mlstm_ref)
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
        # intra-chunk: D[t,s] = exp(g_s - M_t) for s <= t (selected after
        # the exp, as the reference: the masked half may overflow)
        Dlog = g[:, None, :, :] - M[:, :, None, :]         # (B,t,s,H)
        D = torch.where(causal, torch.exp(Dlog), 0.0)
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
    carry)."""
    C, n, m_prev = carry
    f32 = torch.float32
    qs, ks, vs = (t[:, 0].to(f32) for t in (q, k, v))
    lis, lfs = li[:, 0].to(f32), lf[:, 0].to(f32)
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


def mlstm_recurrent_ref(q, k, v, li, lf):
    """Step-by-step recurrent oracle.  Same layout as ``mlstm_ref``."""
    b, h, s, dh = q.shape
    f32 = torch.float32
    carry = (q.new_zeros((b, h, dh, dh), dtype=f32),
             q.new_zeros((b, h, dh), dtype=f32),
             q.new_full((b, h), NEG_BIG, dtype=f32))
    outs = []
    for t in range(s):
        ht, carry = mlstm_step(q[:, :, t][:, None], k[:, :, t][:, None],
                               v[:, :, t][:, None], li[:, :, t][:, None],
                               lf[:, :, t][:, None], carry)
        outs.append(ht[:, 0])
    return torch.stack(outs, dim=2)                        # (B,H,S,dh)
