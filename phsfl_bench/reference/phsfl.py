"""Plain reference of a PHSFL round (paper Eqs. 12-16) and of the
per-client head fine-tuning (Eq. 18).  Nothing of the port is imported.

A round: every client starts from the global model, takes ``kappa0``
SGD steps on its own micro-batches with the head frozen (Eq. 12); each
edge server averages its clients' models with weights alpha_u (Eqs.
14-15); the cloud averages the edge models with weights alpha_b (Eq.
16).  The configuration's precision: the parameters and gradients in
bfloat16, an update lr * g rounded to that dtype and added in float32,
each average taken in float32 and rounded back.

The head bank: the trunk is frozen, so each client's final hidden
states come from one forward pass; then K SGD steps on the head alone,
w <- w - lr * g, each product rounded to the head's dtype.
"""

from __future__ import annotations

import torch

from phsfl_bench.reference.common import F32, Numerics, lm_loss

HEAD = "lm_head"


def _leaves(tree, prefix=""):
    for k in sorted(tree):
        p = f"{prefix}/{k}" if prefix else k
        if isinstance(tree[k], dict):
            yield from _leaves(tree[k], p)
        else:
            yield p, tree[k]


def _rebuild(tree, flat: dict, prefix=""):
    return {k: (_rebuild(v, flat, f"{prefix}/{k}" if prefix else k)
                if isinstance(v, dict) else flat[f"{prefix}/{k}" if prefix
                                                 else k])
            for k, v in tree.items()}


def sgd_steps(family, params: dict, cfg: dict, micro_batches: list,
              lr: float, num: Numerics, first: dict | None = None):
    """One client's local steps from ``params``: (new params, losses).
    The head (``lm_head``) does not train.  ``first``, when given, takes
    each leaf's (gradient norm, elements its update moved) at the first
    step."""
    flat = dict(_leaves(params))
    losses = []
    for i, mb in enumerate(micro_batches):
        train = {p: t.detach().requires_grad_(not p.startswith(HEAD))
                 for p, t in flat.items()}
        loss = family.loss(_rebuild(params, train), cfg, mb, num)
        names = [p for p, t in train.items() if t.requires_grad]
        grads = torch.autograd.grad(loss, [train[p] for p in names])
        losses.append(loss.detach().to(F32))
        step = torch.tensor(-lr, dtype=F32)
        for p, g in zip(names, grads):
            u = g * step.to(g.dtype).item()
            new = (flat[p].to(F32) + u.to(F32)).to(flat[p].dtype)
            if i == 0 and first is not None:
                first[p] = (float(g.to(F32).norm()),
                            int((new != flat[p]).sum()))
            flat[p] = new
        del train, grads, loss
    return _rebuild(params, flat), torch.stack(losses)


def average(trees: list, weights: list) -> dict:
    """sum_i w_i tree_i in float32, rounded to each leaf's dtype."""
    flat = [dict(_leaves(t)) for t in trees]
    out = {}
    for p, t0 in flat[0].items():
        acc = torch.zeros(t0.shape, dtype=F32, device=t0.device)
        for f, w in zip(flat, weights):
            acc += f[p].to(F32) * w
        out[p] = acc.to(t0.dtype)
    return _rebuild(trees[0], out)


def round_(family, params: dict, cfg: dict, client_batches: list,
           edge_servers: int, lr: float, num: Numerics,
           first: dict | None = None):
    """One PHSFL round with global aggregation from the global model
    ``params``: (new global model, mean local loss).  ``client_batches``
    holds each client's list of micro-batches, clients of one edge
    server consecutive; alpha_u and alpha_b are uniform.  ``first`` as
    ``sgd_steps`` takes it, from client 0."""
    c = len(client_batches)
    per = c // edge_servers
    edge_models, losses = [], []
    for b in range(edge_servers):
        models = []
        for u in range(b * per, (b + 1) * per):
            m, ls = sgd_steps(family, params, cfg, client_batches[u], lr, num,
                              first if u == 0 else None)
            models.append(m)
            losses.append(ls.mean())
        edge_models.append(average(models, [1.0 / per] * per))
        del models
    new = average(edge_models, [1.0 / edge_servers] * edge_servers)
    return new, torch.stack(losses).mean()


def head_bank(hidden, labels, w0, steps: int, lr: float, num: Numerics):
    """Each client's head after ``steps`` SGD steps from ``w0`` on its
    hidden states (C,B,S,D) and labels (C,B,S): (bank (C,D,V), losses
    (C,steps), each the loss before its step)."""
    c = hidden.shape[0]
    bank = torch.empty((c, *w0.shape), dtype=w0.dtype, device=w0.device)
    losses = torch.empty((c, steps), dtype=F32, device=w0.device)
    for ci in range(c):
        w = w0
        for k in range(steps):
            w = w.detach().requires_grad_(True)
            loss = lm_loss(num, w, hidden[ci], labels[ci])
            (g,) = torch.autograd.grad(loss, [w])
            w = w.detach() - lr * g.to(w.dtype)
            losses[ci, k] = loss.detach()
        bank[ci] = w
    return bank, losses
