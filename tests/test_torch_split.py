"""Port parity for the split exchange (Steps 3.2–3.8): ``split_grad``
against ``repro.core.fedsim.split_grad`` at every cut, and Remark 2 on the
port side.

Tolerance: rtol 1e-5, atol 1e-6 on losses and gradients.  Both sides run
float32 on the CPU with different convolution and matmul kernels, which
sum in another order.  With deterministic int8 on the wire the activations
are quantized before the server sees them: both sides then round the same
values, so the same tolerance holds (a flipped rounding would show as a
one-quantum error far above it).
"""

import numpy as np
import pytest
import torch

import jax

from repro.compress import link_codecs as j_link_codecs
from repro.configs.phsfl_cnn import CNNConfig as JCNNConfig
from repro.core import fedsim as jfs
from repro.models import cnn as jcnn
from repro_torch.compress import link_codecs
from repro_torch.convert import params_from_numpy
from repro_torch.core import fedsim as tfs
from repro_torch.utils.tree import tree_leaves

SMALL = dict(image_size=16, conv1_filters=8, conv2_filters=16, fc_hidden=32)
TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def setup():
    jp = jcnn.init(jax.random.PRNGKey(2), JCNNConfig(**SMALL))
    r = np.random.default_rng(1)
    x = r.normal(size=(8, 16, 16, 3)).astype(np.float32)
    y = r.integers(0, 10, size=8).astype(np.int32)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return jp, tp, x, y


def _assert_grads_close(g_t, g_j):
    for k in g_j:
        for n in g_j[k]:
            np.testing.assert_allclose(g_t[k][n].numpy(),
                                       np.asarray(g_j[k][n]), **TOL,
                                       err_msg=f"{k}/{n}")


@pytest.mark.parametrize("codec", [None, "int8-det"])
@pytest.mark.parametrize("cut", jcnn.CUT_CANDIDATES)
def test_split_grad_matches_jax(setup, cut, codec):
    jp, tp, x, y = setup
    if codec is None:
        l_j, g_j = jfs.split_grad(jp, x, y, cut)
        l_t, g_t = tfs.split_grad(tp, torch.from_numpy(x),
                                  torch.from_numpy(y), cut)
    else:
        l_j, g_j = jfs.split_grad(
            jp, x, y, cut, codecs=j_link_codecs("int8", stochastic=False),
            key=jax.random.PRNGKey(0))
        l_t, g_t = tfs.split_grad(
            tp, torch.from_numpy(x), torch.from_numpy(y), cut,
            codecs=link_codecs("int8", stochastic=False),
            generator=torch.Generator().manual_seed(0))
    np.testing.assert_allclose(float(l_t), float(l_j), **TOL)
    _assert_grads_close(g_t, g_j)


def test_split_grad_int8_is_in_play(setup):
    _, tp, x, y = setup
    xs, ys = torch.from_numpy(x), torch.from_numpy(y)
    l0, g0 = tfs.split_grad(tp, xs, ys)
    l1, g1 = tfs.split_grad(tp, xs, ys, codecs=link_codecs("int8"),
                            generator=torch.Generator().manual_seed(7))
    assert float(l1) != float(l0)
    np.testing.assert_allclose(float(l1), float(l0), rtol=0.1)
    assert not torch.equal(g1["conv1"]["w"], g0["conv1"]["w"])


def test_remark2_same_gradients_at_every_cut(setup):
    """Remark 2 on the port side: the exchange replays the same chain rule
    through any cut, so the gradients are the same at every cut (exact),
    and match monolithic backprop up to float re-association."""
    _, tp, x, y = setup
    xs, ys = torch.from_numpy(x), torch.from_numpy(y)
    runs = [tfs.split_grad(tp, xs, ys, cut) for cut in jcnn.CUT_CANDIDATES]
    l0, g0 = runs[0]
    for loss, g in runs[1:]:
        assert float(loss) == float(l0)
        for a, b in zip(tree_leaves(g), tree_leaves(g0)):
            assert torch.equal(a, b)
    lm, gm = tfs.monolithic_grad(tp, xs, ys)
    torch.testing.assert_close(lm, l0, **TOL)
    for a, b in zip(tree_leaves(gm), tree_leaves(g0)):
        torch.testing.assert_close(a, b, **TOL)


def test_identity_codecs_bit_identical_and_lossy_needs_generator(setup):
    _, tp, x, y = setup
    xs, ys = torch.from_numpy(x), torch.from_numpy(y)
    l0, g0 = tfs.split_grad(tp, xs, ys)
    # lossless codecs never draw, so no generator is needed...
    l1, g1 = tfs.split_grad(tp, xs, ys, codecs=link_codecs("fp32"))
    assert float(l1) == float(l0)
    for a, b in zip(tree_leaves(g1), tree_leaves(g0)):
        assert torch.equal(a, b)
    # ...but a lossy codec without one must raise (deterministic rounding
    # included, as in the reference)
    for kw in ({}, {"stochastic": False}):
        with pytest.raises(ValueError, match="generator"):
            tfs.split_grad(tp, xs, ys, codecs=link_codecs("int8", **kw))


def test_stacked_split_grad_gives_each_client_its_own_gradient(setup):
    """Summing the per-client mean losses gives each client exactly its
    own gradient: the stacked exchange equals U single exchanges."""
    _, tp, x, y = setup
    xs, ys = torch.from_numpy(x), torch.from_numpy(y)
    stacked = {k: {n: torch.stack([v, v * 0.5]) for n, v in tp[k].items()}
               for k in tp}
    xx, yy = torch.stack([xs, xs.flip(0)]), torch.stack([ys, ys.flip(0)])
    loss, g = tfs.split_grad_stacked(stacked, xx, yy)
    for u in range(2):
        one = {k: {n: v[u] for n, v in stacked[k].items()} for k in stacked}
        l1, g1 = tfs.split_grad(one, xx[u], yy[u])
        torch.testing.assert_close(loss[u], l1, **TOL)
        for a, b in zip(tree_leaves(g), tree_leaves(g1)):
            torch.testing.assert_close(a[u], b, **TOL)
