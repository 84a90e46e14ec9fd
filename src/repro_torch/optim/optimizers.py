"""Optimizers (``repro.optim.optimizers``), over dict trees of tensors.

The API mirrors the reference's optax-like style:

    opt = masked(sgd(lr), trainable_mask)
    state = opt.init(params)
    updates, state = opt.update(grads, state, params)
    params = apply_updates(params, updates)

``masked`` zeroes updates where the mask is False: the PHSFL frozen head
(Eq. 12 of the paper: lr=0 for w_{1,hd}), and the personalization phase
(Eq. 18: only the head trains) with the complementary mask.

The reference's dtype rules hold exactly.  A Python-float factor takes
the tensor's dtype first (JAX's weak typing): ``-lr * g`` on a bfloat16
gradient multiplies by bfloat16(-lr), where torch alone would multiply by
the float32 value, so ``_scale`` rounds the factor to the tensor's dtype
before the product.  A factor that is a float32 tensor (a schedule's
learning rate, the clip scale) promotes a bfloat16 operand to float32, as
JAX's promotion does.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from repro_torch.utils.tree import tree_leaves, tree_map

PyTree = Any


class Optimizer(NamedTuple):
    init: Callable[[PyTree], PyTree]
    update: Callable[[PyTree, PyTree, PyTree], tuple[PyTree, PyTree]]


def _lr_at(lr, count):
    return lr(count) if callable(lr) else lr


def _scale(factor, x: torch.Tensor) -> torch.Tensor:
    """``factor * x`` under JAX's promotion: a Python number is weak (it
    takes x's dtype, rounded there), a tensor is not."""
    if isinstance(factor, torch.Tensor):
        dtype = torch.promote_types(x.dtype, factor.dtype)
        return factor.to(x.device) * x.to(dtype)
    return x * torch.tensor(factor, dtype=x.dtype).item()


def _count0(params) -> torch.Tensor:
    leaves = tree_leaves(params)
    device = leaves[0].device if leaves else "cpu"
    return torch.zeros((), dtype=torch.int32, device=device)


def sgd(lr) -> Optimizer:
    """Plain SGD (the paper's optimizer; no state beyond a step count)."""

    def init(params):
        return {"count": _count0(params)}

    def update(grads, state, params):
        step_lr = _lr_at(lr, state["count"])
        updates = tree_map(lambda g: _scale(-step_lr, g), grads)
        return updates, {"count": state["count"] + 1}

    return Optimizer(init, update)


def momentum(lr, beta: float = 0.9, nesterov: bool = False) -> Optimizer:
    def init(params):
        return {"count": _count0(params),
                "mu": tree_map(torch.zeros_like, params)}

    def update(grads, state, params):
        mu = tree_map(lambda m, g: _scale(beta, m) + g, state["mu"], grads)
        if nesterov:
            upd = tree_map(lambda m, g: g + _scale(beta, m), mu, grads)
        else:
            upd = mu
        step_lr = _lr_at(lr, state["count"])
        updates = tree_map(lambda u: _scale(-step_lr, u), upd)
        return updates, {"count": state["count"] + 1, "mu": mu}

    return Optimizer(init, update)


def adamw(lr, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 0.0) -> Optimizer:
    """Adam with decoupled weight decay; float32 moments and bias
    corrections whatever the parameters' dtype."""
    f32 = torch.float32

    def init(params):
        z = lambda p: torch.zeros_like(p, dtype=f32)
        return {"count": _count0(params),
                "m": tree_map(z, params), "v": tree_map(z, params)}

    def update(grads, state, params):
        count = state["count"] + 1
        m = tree_map(lambda m_, g: b1 * m_ + (1 - b1) * g.to(f32),
                     state["m"], grads)
        v = tree_map(lambda v_, g: b2 * v_ + (1 - b2) * torch.square(
            g.to(f32)), state["v"], grads)
        c1 = 1 - b1 ** count.to(f32)
        c2 = 1 - b2 ** count.to(f32)
        step_lr = _lr_at(lr, count)

        def upd(m_, v_, p):
            u = (m_ / c1) / (torch.sqrt(v_ / c2) + eps)
            if weight_decay:
                u = u + weight_decay * p.to(f32)
            return _scale(-step_lr, u).to(p.dtype)

        updates = tree_map(upd, m, v, params)
        return updates, {"count": count, "m": m, "v": v}

    return Optimizer(init, update)


def masked(opt: Optimizer, mask: PyTree) -> Optimizer:
    """Apply ``opt`` only where mask is True; zero updates elsewhere.

    Inner state is kept for every leaf (so a state checkpoint has the
    reference's keys); the masked leaves simply never move.  ``mask`` is
    a tree of Python bools matching the params tree structure.
    """

    def init(params):
        return opt.init(params)

    def update(grads, state, params):
        # zero the frozen leaves' gradients before the inner update, so
        # that stateful optimizers accumulate no moments for them either
        gz = tree_map(lambda m, g: g if m else zeros_view(g), mask, grads)
        updates, state = opt.update(gz, state, params)
        updates = tree_map(lambda m, u: u if m else zeros_view(u), mask,
                           updates)
        return updates, state

    return Optimizer(init, update)


def zeros_view(t: torch.Tensor) -> torch.Tensor:
    """Zeros of ``t``'s shape, dtype and device as one element broadcast
    (stride 0): what a frozen leaf's gradient and update hold, without a
    buffer of the leaf's size."""
    return torch.zeros((), dtype=t.dtype, device=t.device).expand(t.shape)


def apply_updates(params: PyTree, updates: PyTree, mask=None) -> PyTree:
    """p + u added in float32, cast back to the parameter's dtype.  Where
    ``mask`` (a tree of Python bools, as ``masked`` takes) is False the
    update is ``masked``'s zero and the parameter itself is returned: the
    same values without the float32 round trip."""
    f32 = torch.float32
    add = lambda p, u: (p.to(f32) + u.to(f32)).to(p.dtype)
    if mask is None:
        return tree_map(add, params, updates)
    return tree_map(lambda p, u, m: add(p, u) if m else p, params, updates,
                    mask)


def global_norm(tree: PyTree) -> torch.Tensor:
    sq = [torch.sum(torch.square(x.to(torch.float32)))
          for x in tree_leaves(tree)]
    return torch.sqrt(sum(sq))


def clip_by_global_norm(grads: PyTree, max_norm: float) -> PyTree:
    g = global_norm(grads)
    scale = torch.clamp(max_norm / (g + 1e-9), max=1.0)
    return tree_map(lambda x: _scale(scale, x), grads)


def make_optimizer(name: str, lr, *, momentum_beta: float = 0.9,
                   weight_decay: float = 0.0) -> Optimizer:
    if name == "sgd":
        return sgd(lr)
    if name == "momentum":
        return momentum(lr, momentum_beta)
    if name == "adamw":
        return adamw(lr, weight_decay=weight_decay)
    raise ValueError(f"unknown optimizer {name!r}")
