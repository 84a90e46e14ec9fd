"""Port parity for activation checkpointing (``remat``,
``models.transformer.remat_wrapper``) on seamless-m4t-medium,
xlstm-350m and recurrentgemma-2b at reduced sizes, on the reference's own
parameters: the loss and every gradient under ``remat=True`` with the
policies "full" and "dots" against ``remat=False``, and against the
reference's ``model.loss(..., remat=True)`` gradients.

The configs reach every granularity: xlstm at 6 layers and
recurrentgemma at 8 have a lead layer, a scan stage of two repeats (one
checkpoint a pattern period) and a tail layer; seamless one checkpoint per
encoder and per decoder layer; olmoe-1b-7b one a layer.  The blocks are
attention (K2's wrapper, its plain version here), mLSTM (K3's), sLSTM
(its loop over time), RG-LRU (K4's) with local attention, and the MoE FFN
(widened to 8 experts, top-2, as ``tests/test_torch_moe.py`` widens it),
whose expert loop's one-node backward runs once a MoE layer under either
policy, after the recompute ran its forward again.

On the CPU the recompute is bit-equal to the forward: the loss and every
gradient under either policy equal ``remat=False`` bit for bit.  Against
the reference: 1e-4 on the gradients, the transformer tests' own.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_arch as j_get_arch
from repro.models import build_model as j_build
from repro_torch.configs.registry import get_arch
from repro_torch.convert import params_from_numpy
from repro_torch.models import moe as tmoe
from repro_torch.models.registry import build_model
from repro_torch.models.transformer import remat_wrapper
from repro_torch.utils.tree import path_leaves, tree_leaves, tree_map

TOL = 1e-4
BATCH, SEQ = 2, 16
ARCHS = {"seamless-m4t-medium": {}, "xlstm-350m": {"num_layers": 6},
         "recurrentgemma-2b": {"num_layers": 8}, "olmoe-1b-7b": {}}
MOE = {"olmoe-1b-7b": dict(num_experts=8, top_k=2)}
POLICIES = {"full": None, "dots": "dots"}


def _batch(cfg, seed=2):
    r = np.random.default_rng(seed)
    toks = r.integers(0, cfg.vocab_size, (BATCH, SEQ)).astype(np.int32)
    batch = {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}
    if cfg.encdec is not None:
        batch["source_embeds"] = (0.02 * r.normal(size=(
            BATCH, cfg.encdec.max_source_len, cfg.d_model))).astype(
            np.float32)
    return batch


def _config(get_arch_fn, name):
    cfg = get_arch_fn(name).reduced(**ARCHS[name])
    if name in MOE:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, **MOE[name]))
    return cfg


def _loss_and_grads(tm, tp, batch, **kw):
    """The loss, every leaf's gradient, and the grouped MoE backwards
    the backward took."""
    tree = tree_map(lambda t: t.clone().requires_grad_(), tp)
    loss = tm.loss(tree, {k: torch.from_numpy(v) for k, v in batch.items()},
                   **kw)
    before = tmoe.grouped_backwards
    grads = torch.autograd.grad(loss, tree_leaves(tree))
    return (loss.detach(), dict(zip([p for p, _ in path_leaves(tree)],
                                    grads)),
            tmoe.grouped_backwards - before)


@pytest.fixture(scope="module", params=list(ARCHS))
def arch(request):
    """The reference's parameters (PRNGKey(0)) and their port copy, a
    batch, and the port's loss and gradients without remat."""
    name = request.param
    j_cfg = _config(j_get_arch, name)
    cfg = _config(get_arch, name)
    jm, tm = j_build(j_cfg), build_model(cfg)
    jp = jax.jit(jm.init)(jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    batch = _batch(cfg)
    return dict(name=name, jm=jm, tm=tm, jp=jp, tp=tp, batch=batch,
                plain=_loss_and_grads(tm, tp, batch), runs={})


def _remat_run(arch, policy):
    if policy not in arch["runs"]:
        arch["runs"][policy] = _loss_and_grads(
            arch["tm"], arch["tp"], arch["batch"], remat=True,
            remat_policy=POLICIES[policy])
    return arch["runs"][policy]


@pytest.mark.parametrize("policy", list(POLICIES))
def test_remat_is_bit_equal_to_no_remat(arch, policy):
    loss, grads, _ = _remat_run(arch, policy)
    want_loss, want, _ = arch["plain"]
    assert torch.equal(loss, want_loss)
    assert grads.keys() == want.keys()
    for path in want:
        assert torch.equal(grads[path], want[path]), path


@pytest.mark.parametrize("policy", list(POLICIES))
def test_remat_gradients_match_reference_remat(arch, policy):
    """The port's remat gradients against the reference's
    ``jax.checkpoint`` ones under the same policy (None for "full", as
    ``_local_scan`` passes it)."""
    jb = {k: jnp.asarray(v) for k, v in arch["batch"].items()}
    want_loss, want = jax.jit(jax.value_and_grad(
        lambda p: arch["jm"].loss(p, jb, remat=True,
                                  remat_policy=POLICIES[policy])))(
        arch["jp"])
    want = dict(path_leaves(jax.tree.map(np.asarray, want)))
    loss, grads, _ = _remat_run(arch, policy)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=TOL,
                               atol=TOL)
    assert grads.keys() == want.keys()
    for path, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[path], rtol=TOL,
                                   atol=TOL, err_msg=path)


@pytest.mark.parametrize("policy", list(POLICIES))
def test_remat_takes_one_grouped_moe_backward_a_layer(arch, policy):
    """The MoE's one-node backward runs once a MoE layer with or without
    remat (the recompute's node runs no backward of its own); none in
    the other families."""
    moe_layers = arch["tm"].cfg.num_layers if arch["name"] in MOE else 0
    assert arch["plain"][2] == moe_layers
    assert _remat_run(arch, policy)[2] == moe_layers


def test_dots_saves_the_matmuls_and_recomputes_the_rest():
    """Under "dots" the backward finds the ``aten.mm`` outputs saved and
    recomputes the rest (the tanh here); under "full" it recomputes both.
    Counted by the ops the recompute runs."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.seen = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.seen.append(func.overloadpacket.__name__)
            return func(*args, **(kwargs or {}))

    w = torch.randn(8, 8, requires_grad=True)
    x = torch.randn(4, 8, requires_grad=True)

    def block(x):
        return torch.tanh(x @ w).sum()

    recomputed = {}
    for policy in POLICIES.values():
        y = remat_wrapper(True, policy)(block)(x)
        with Ops() as ops:
            y.backward()
        recomputed[policy] = ops.seen
    assert "tanh" in recomputed["dots"] and "tanh" in recomputed[None]
    assert (recomputed[None].count("mm")
            == recomputed["dots"].count("mm") + 1)
    assert remat_wrapper(False, "dots")(block) is block
