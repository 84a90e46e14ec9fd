"""Port parity for the MoE FFN (``repro_torch.models.moe``) against the
reference's ``repro.models.moe``, with the reference's parameters carried
in.

``reduced()`` gives both MoE architectures 4 experts with top_k 4, so
every token goes to every expert and the sort, the grouped matmuls and
the combine are never really exercised.  The configs here widen it:
olmoe-1b-7b to 8 experts, top-2; deepseek-v2-236b to 8 experts, top-3,
with its shared expert.  Cases: a (B, S, D) prefill-shaped input, a
decode-shaped (B, 1, D) one, and an expert that no token picks.

Tolerances (float32): 1e-5 on the output, 1e-6 on the auxiliary loss,
1e-4 on the gradients of the parameters and the input.  The combine is
deterministic: two calls agree bit for bit.

The expert loop's one-node backward (``_GroupedExperts``) is held to the
per-slice autograd loop it replaced (``slice_loop`` here), bit for bit in
float32 and bf16: every leaf's gradient and the input's, an expert with
no pairs (its slices exactly zero), frozen leaves (no gradient), and the
counter ``grouped_backwards`` (one a MoE layer backward, none under
``no_grad``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs.registry import get_arch as j_get_arch
from repro.models import moe as jmoe
from repro_torch.configs.registry import get_arch
from repro_torch.convert import params_from_numpy
from repro_torch.models import moe as tmoe
from repro_torch.models.layers import activation
from repro_torch.utils.tree import path_leaves, tree_leaves, tree_map

OUT_TOL, AUX_TOL, GRAD_TOL = 1e-5, 1e-6, 1e-4
WIDENED = {"olmoe-1b-7b": dict(num_experts=8, top_k=2),
           "deepseek-v2-236b": dict(num_experts=8, top_k=3)}


def widened(cfg, arch):
    return dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, **WIDENED[arch]))


@pytest.fixture(scope="module", params=sorted(WIDENED))
def setup(request):
    arch = request.param
    j_cfg = widened(j_get_arch(arch).reduced(), arch)
    cfg = widened(get_arch(arch).reduced(), arch)
    jp = jmoe.moe_init(jax.random.PRNGKey(3), j_cfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return arch, j_cfg, cfg, jp, tp


def _x(shape, seed, positive=False):
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    return np.abs(x) if positive else x


def _both(setup, x, jp=None, tp=None):
    _, j_cfg, cfg, jp0, tp0 = setup
    jo, ja = jmoe.moe_apply(jp or jp0, j_cfg, jnp.asarray(x))
    to, ta = tmoe.moe_apply(tp or tp0, cfg, torch.from_numpy(x))
    return (np.asarray(jo), float(ja)), (to, ta)


def test_widened_config_matches_reference(setup):
    arch, j_cfg, cfg, _, tp = setup
    assert dataclasses.asdict(cfg) == dataclasses.asdict(j_cfg)
    assert ("shared" in tp) == (arch == "deepseek-v2-236b")
    assert cfg.moe.top_k < cfg.moe.num_experts


def test_param_tree_matches_reference(setup):
    _, _, cfg, _, tp = setup
    ours = tmoe.moe_init(torch.Generator().manual_seed(0), cfg)
    assert ({p: (tuple(t.shape), t.dtype) for p, t in path_leaves(ours)}
            == {p: (tuple(t.shape), t.dtype) for p, t in path_leaves(tp)})
    assert ours["router"]["w"].dtype == torch.float32


@pytest.mark.parametrize("shape", [(2, 24, 256), (3, 1, 256)],
                         ids=["prefill", "decode"])
def test_output_and_aux_match_reference(setup, shape):
    (jo, ja), (to, ta) = _both(setup, _x(shape, 1))
    assert to.shape == shape and to.dtype == torch.float32
    assert ta.dtype == torch.float32 and ta.shape == ()
    np.testing.assert_allclose(to.numpy(), jo, rtol=OUT_TOL, atol=OUT_TOL)
    np.testing.assert_allclose(float(ta), ja, rtol=AUX_TOL, atol=AUX_TOL)


def test_gradients_match_reference(setup):
    """d/d(params, x) of sum(out * w) + aux: the router's gradient comes
    through the renormalised top-k weights and the aux loss."""
    _, j_cfg, cfg, jp, tp = setup
    x = _x((2, 24, 256), 2)
    w = _x((2, 24, 256), 3)

    def j_obj(p, xx):
        o, a = jmoe.moe_apply(p, j_cfg, xx)
        return (o * jnp.asarray(w)).sum() + a

    jg_p, jg_x = jax.grad(j_obj, argnums=(0, 1))(jp, jnp.asarray(x))
    tree = tree_map(lambda t: t.clone().requires_grad_(), tp)
    xt = torch.from_numpy(x).requires_grad_()
    o, a = tmoe.moe_apply(tree, cfg, xt)
    obj = (o * torch.from_numpy(w)).sum() + a
    paths = [path for path, _ in path_leaves(tree)]
    grads = torch.autograd.grad(obj, [xt, *tree_leaves(tree)])
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(jg_x),
                               rtol=GRAD_TOL, atol=GRAD_TOL)
    want = dict(path_leaves(jax.tree.map(np.asarray, jg_p)))
    assert set(paths) == set(want)
    for path, g in zip(paths, grads[1:]):
        np.testing.assert_allclose(g.numpy(), want[path], rtol=GRAD_TOL,
                                   atol=GRAD_TOL, err_msg=path)


def test_expert_with_no_tokens(setup):
    """A router column that loses every token (positive inputs, a large
    negative weight): that expert's group is empty and is skipped."""
    _, j_cfg, cfg, jp, tp = setup
    x = _x((2, 24, 256), 4, positive=True)
    router = np.asarray(jp["router"]["w"]).copy()
    router[:, 5] = -1.0
    jp2 = dict(jp, router={"w": jnp.asarray(router)})
    tp2 = dict(tp, router={"w": torch.from_numpy(router)})
    _, top_e, counts, _ = tmoe.route(tp2, cfg,
                                     torch.from_numpy(x).reshape(-1, 256))
    assert torch.equal(counts, torch.bincount(top_e.reshape(-1),
                                              minlength=8))
    assert counts[5] == 0 and (counts > 0).sum() >= cfg.moe.top_k
    (jo, ja), (to, ta) = _both(setup, x, jp2, tp2)
    np.testing.assert_allclose(to.numpy(), jo, rtol=OUT_TOL, atol=OUT_TOL)
    np.testing.assert_allclose(float(ta), ja, rtol=AUX_TOL, atol=AUX_TOL)


def test_combine_repeats_bit_for_bit(setup):
    _, _, cfg, _, tp = setup
    x = torch.from_numpy(_x((2, 24, 256), 5))
    before = tmoe.group_size_reads
    a, aux_a = tmoe.moe_apply(tp, cfg, x)
    b, aux_b = tmoe.moe_apply(tp, cfg, x)
    assert tmoe.group_size_reads == before + 2      # one host read a call
    assert torch.equal(a, b) and torch.equal(aux_a, aux_b)


def test_router_weights_renormalise_with_the_clamp(setup):
    _, _, cfg, _, tp = setup
    x = torch.from_numpy(_x((1, 8, 256), 6))
    top_w, top_e, counts, _ = tmoe.route(tp, cfg, x.reshape(-1, 256))
    assert top_w.dtype == torch.float32
    torch.testing.assert_close(top_w.sum(-1), torch.ones(8))
    assert bool((top_w[:, :-1] >= top_w[:, 1:]).all())   # sorted, as top_k
    assert top_e.shape == (8, cfg.moe.top_k)
    assert int(counts.sum()) == 8 * cfg.moe.top_k


def test_model_backward_repeats_bit_for_bit():
    """F4's witness: two backward passes of olmoe-1b-7b reduced to four
    layers give the same gradients, bit for bit (the dispatch's gather of
    repeated tokens once summed them in thread order)."""
    from repro_torch.models.registry import build_model
    from repro_torch.utils.prng import make_generator
    cfg = get_arch("olmoe-1b-7b").reduced(num_layers=4)
    model = build_model(cfg)
    params = model.init(make_generator(0))
    rng = np.random.default_rng(7)
    mb = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 64))
                              .astype(np.int32)) for k in ("tokens",
                                                            "labels")}

    def grads():
        leaves = tree_map(lambda t: t.detach().requires_grad_(), params)
        return torch.autograd.grad(model.loss(leaves, mb),
                                   tree_leaves(leaves))

    first = grads()
    assert all(torch.equal(a, b) for a, b in zip(first, grads()))


# ------------------------------------------- the expert loop's backward ----
def slice_loop(xs, w_gate, w_up, w_down, sizes, act_name):
    """The expert loop as autograd records it slice by slice (the port's
    before ``_GroupedExperts``): the plain version of its backward."""
    act = activation(act_name)
    segs, pos = [], 0
    for e, g in enumerate(sizes):
        if g:
            xe = xs[pos:pos + g]
            h = act(xe @ w_gate[e]) * (xe @ w_up[e])
            segs.append(h @ w_down[e])
            pos += g
    return torch.cat(segs)


DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


class _MatmulCount(TorchDispatchMode):
    """Counts the matrix products (``aten.mm``, any overload) run."""

    def __init__(self):
        super().__init__()
        self.mm = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.mm += func.overloadpacket is torch.ops.aten.mm
        return func(*args, **(kwargs or {}))


def _moe_grads(cfg, params, x, w, frozen=()):
    """moe_apply's output and aux, and the gradients of sum(out * w) +
    aux (``.backward()``) on every leaf and on x but those named in
    ``frozen`` ("x" or a top-level key), which take none; the counter's
    rise; and the matrix products the backward ran."""
    tree = {k: tree_map(lambda t, k=k: t.clone().requires_grad_(
        k not in frozen), v) for k, v in params.items()}
    xt = x.clone().requires_grad_("x" not in frozen)
    before = tmoe.grouped_backwards
    o, a = tmoe.moe_apply(tree, cfg, xt)
    with _MatmulCount() as count:
        ((o * w).sum() + a).backward()
    grads = {path: t.grad for path, t in path_leaves(tree)}
    grads["x"] = xt.grad
    return (o.detach(), a.detach(), grads, tmoe.grouped_backwards - before,
            count.mm)


def _params_and_input(cfg, dtype, seed, no_pairs):
    params = tmoe.moe_init(torch.Generator().manual_seed(seed), cfg, dtype)
    x = torch.from_numpy(_x((2, 24, cfg.d_model), seed, positive=no_pairs))
    if no_pairs:    # expert 5 loses every token (test_expert_with_no_tokens)
        params["router"]["w"][:, 5] = -1.0
    return params, x.to(dtype), torch.from_numpy(
        _x((2, 24, cfg.d_model), seed + 1)).to(dtype)


@pytest.mark.parametrize("case", ["routed", "no_pairs"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_grouped_backward_equals_the_slice_loop(setup, dtype, case,
                                                monkeypatch):
    """Every leaf's gradient and the input's equal the slice loop's bit
    for bit; with an expert that got no pairs its slices are exactly
    zero; one backward through the node."""
    _, _, cfg, _, _ = setup
    params, x, w = _params_and_input(cfg, DTYPES[dtype], 11,
                                     case == "no_pairs")
    out, aux, got, n, mm = _moe_grads(cfg, params, x, w)
    assert n == 1
    monkeypatch.setattr(tmoe._GroupedExperts, "apply", slice_loop)
    want_out, want_aux, want, n_plain, want_mm = _moe_grads(cfg, params,
                                                            x, w)
    assert n_plain == 0 and mm == want_mm
    assert torch.equal(out, want_out) and torch.equal(aux, want_aux)
    assert got.keys() == want.keys()
    for path in want:
        assert got[path].dtype == want[path].dtype, path
        assert torch.equal(got[path], want[path]), path
    if case == "no_pairs":
        counts = tmoe.route(params, cfg, x.reshape(-1, cfg.d_model))[2]
        assert counts[5] == 0 and counts.sum() > 0
        for k in ("w_gate", "w_up", "w_down"):
            assert not got[k][5].any() and got[k].any(), k


@pytest.mark.parametrize("frozen", ["w_up", "x"])
def test_frozen_leaf_gets_no_gradient(setup, frozen, monkeypatch):
    """A leaf (or the input) that does not require grad gets none, and
    its products are skipped: the backward runs as many matrix products
    as the slice loop's, fewer than with every leaf trained; the others'
    gradients equal the slice loop's bit for bit."""
    _, _, cfg, _, _ = setup
    params, x, w = _params_and_input(cfg, torch.bfloat16, 12, False)
    _, _, got, n, mm = _moe_grads(cfg, params, x, w, frozen=(frozen,))
    *_, mm_all = _moe_grads(cfg, params, x, w)
    monkeypatch.setattr(tmoe._GroupedExperts, "apply", slice_loop)
    *_, want, _, want_mm = _moe_grads(cfg, params, x, w, frozen=(frozen,))
    assert n == 1 and mm == want_mm and mm < mm_all
    for path in want:
        if path == frozen:
            assert got[path] is None and want[path] is None, path
        else:
            assert torch.equal(got[path], want[path]), path


def test_grouped_backwards_counts_backwards_only(setup):
    """The counter rises at the backward, not the forward, and not at
    all under ``no_grad`` (the loop then runs as it is)."""
    _, _, cfg, _, tp = setup
    tree = tree_map(lambda t: t.clone().requires_grad_(), tp)
    x = torch.from_numpy(_x((2, 24, 256), 13))
    before = tmoe.grouped_backwards
    with torch.no_grad():
        plain, _ = tmoe.moe_apply(tree, cfg, x)
    o, a = tmoe.moe_apply(tree, cfg, x)
    assert tmoe.grouped_backwards == before
    assert torch.equal(o.detach(), plain)
    (o.sum() + a).backward()
    assert tmoe.grouped_backwards == before + 1


def test_model_backward_takes_one_node_a_moe_layer(monkeypatch):
    """olmoe-1b-7b reduced to four layers (all MoE): one grouped backward
    a layer, and every gradient equal to the slice loop's bit for bit."""
    from repro_torch.models.registry import build_model
    from repro_torch.utils.prng import make_generator
    cfg = get_arch("olmoe-1b-7b").reduced(num_layers=4)
    model = build_model(cfg)
    params = model.init(make_generator(1))
    rng = np.random.default_rng(8)
    mb = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 32))
                              .astype(np.int32)) for k in ("tokens",
                                                            "labels")}

    def grads():
        leaves = tree_map(lambda t: t.detach().requires_grad_(), params)
        return torch.autograd.grad(model.loss(leaves, mb),
                                   tree_leaves(leaves))

    before = tmoe.grouped_backwards
    got = grads()
    assert tmoe.grouped_backwards == before + cfg.num_layers
    monkeypatch.setattr(tmoe._GroupedExperts, "apply", slice_loop)
    want = grads()
    assert tmoe.grouped_backwards == before + cfg.num_layers
    assert all(torch.equal(a, b) for a, b in zip(got, want))
