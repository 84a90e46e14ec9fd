"""Port parity for the CNN: the port's forward passes against
``repro.models.cnn`` from the reference's own ``cnn.init`` parameters,
carried across with ``params_from_numpy``.

Tolerance: rtol 1e-5, atol 1e-6 on activations, logits and loss.  Both
sides compute in float32 on the CPU, but with different convolution and
matmul kernels (oneDNN/BLAS against XLA), which sum in another order.
Accounting integers are exact.
"""

import numpy as np
import pytest
import torch

import jax

from repro.configs.phsfl_cnn import CNNConfig as JCNNConfig
from repro.models import cnn as jcnn
from repro_torch.configs.phsfl_cnn import CNNConfig
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.models import cnn

SMALL = dict(image_size=16, conv1_filters=8, conv2_filters=16, fc_hidden=32)
TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def setup():
    jcfg = JCNNConfig(**SMALL)
    jp = jcnn.init(jax.random.PRNGKey(1), jcfg)
    np_params = jax.tree.map(np.asarray, jp)
    r = np.random.default_rng(0)
    x = r.normal(size=(6, 16, 16, 3)).astype(np.float32)
    y = r.integers(0, 10, size=6).astype(np.int32)
    return jp, params_from_numpy(np_params, "cpu"), x, y


@pytest.mark.parametrize("cut", jcnn.CUT_CANDIDATES)
def test_client_and_server_forward_match(setup, cut):
    jp, tp, x, _ = setup
    o_j = jcnn.client_forward(jp, x, cut)
    o_t = cnn.client_forward(tp, torch.from_numpy(x), cut)
    assert tuple(o_t.shape) == o_j.shape           # NHWC at the cut
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), **TOL)
    # the server half from the SAME activations, so its error is its own
    lg_j = jcnn.server_forward(jp, o_j, cut)
    lg_t = cnn.server_forward(tp, torch.from_numpy(np.array(o_j)), cut)
    np.testing.assert_allclose(lg_t.numpy(), np.asarray(lg_j), **TOL)


def test_logits_loss_and_acc_match(setup):
    jp, tp, x, y = setup
    np.testing.assert_allclose(cnn.apply(tp, torch.from_numpy(x)).numpy(),
                               np.asarray(jcnn.apply(jp, x)), **TOL)
    l_j, a_j = jcnn.loss_and_acc(jp, x, y)
    l_t, a_t = cnn.loss_and_acc(tp, torch.from_numpy(x), torch.from_numpy(y))
    np.testing.assert_allclose(float(l_t), float(l_j), **TOL)
    assert float(a_t) == float(a_j)
    np.testing.assert_allclose(
        float(cnn.loss_fn(tp, torch.from_numpy(x), torch.from_numpy(y))),
        float(jcnn.loss_fn(jp, x, y)), **TOL)


@pytest.mark.parametrize("cut", jcnn.CUT_CANDIDATES)
def test_stacked_clients_equal_one_model_each(cut):
    """The written-out client dimension (grouped conv, bmm) computes each
    client as its own model would, with its own parameters."""
    cfg = CNNConfig(**SMALL)
    params = [cnn.init(s, cfg) for s in range(3)]
    stacked = {k: {n: torch.stack([p[k][n] for p in params])
                   for n in params[0][k]} for k in params[0]}
    x = torch.randn(3, 4, 16, 16, 3)
    o = cnn.client_forward_stacked(stacked, x, cut)
    lg = cnn.server_forward_stacked(stacked, o, cut)
    for u in range(3):
        torch.testing.assert_close(o[u], cnn.client_forward(params[u], x[u],
                                                            cut), **TOL)
        torch.testing.assert_close(
            lg[u], cnn.server_forward(params[u], o[u], cut), **TOL)


def test_init_shapes_and_keys_match():
    for kw in (SMALL, {}):
        jp = jcnn.init(jax.random.PRNGKey(0), JCNNConfig(**kw))
        tp = cnn.init(0, CNNConfig(**kw))
        assert set(jp) == set(tp)
        for k in jp:
            assert set(jp[k]) == set(tp[k])
            for n in jp[k]:
                assert tuple(tp[k][n].shape) == jp[k][n].shape
                assert tp[k][n].dtype == torch.float32
        # the same init scheme: zero biases, weights inside the +-2 sigma
        # truncation at the reference's fan-in scale
        for k in tp:
            assert torch.count_nonzero(tp[k]["b"]) == 0
        bound = 2.0 / np.sqrt(3 * 3 * CNNConfig(**kw).channels)
        assert tp["conv1"]["w"].abs().max() <= bound
    # a seed gives the same weights every time
    a, b = cnn.init(5, CNNConfig(**SMALL)), cnn.init(5, CNNConfig(**SMALL))
    assert torch.equal(a["fc1"]["w"], b["fc1"]["w"])


def test_params_round_trip_through_numpy(setup):
    jp, tp, _, _ = setup
    back = params_to_numpy(tp)
    for k in jp:
        for n in jp[k]:
            np.testing.assert_array_equal(back[k][n], np.asarray(jp[k][n]))


@pytest.mark.parametrize("cfg_kw", [SMALL, {}])
@pytest.mark.parametrize("cut", jcnn.CUT_CANDIDATES)
@pytest.mark.parametrize("batch", [1, 32])
def test_accounting_integers_exact(cfg_kw, cut, batch):
    jcfg, tcfg = JCNNConfig(**cfg_kw), CNNConfig(**cfg_kw)
    assert tcfg.flat_dim == jcfg.flat_dim
    assert (cnn.cut_activation_size(tcfg, batch, cut)
            == jcnn.cut_activation_size(jcfg, batch, cut))
    assert (cnn.client_block_flops(tcfg, batch, cut)
            == jcnn.client_block_flops(jcfg, batch, cut))
    assert cnn.client_keys_for(cut) == jcnn.client_keys_for(cut)


def test_key_tuples_and_bad_cut():
    assert cnn.CUT_CANDIDATES == jcnn.CUT_CANDIDATES
    assert cnn.DEFAULT_CUT == jcnn.DEFAULT_CUT
    assert (cnn.CLIENT_KEYS, cnn.BODY_KEYS, cnn.HEAD_KEYS) == (
        jcnn.CLIENT_KEYS, jcnn.BODY_KEYS, jcnn.HEAD_KEYS)
    for fn in (cnn.client_keys_for,
               lambda c: cnn.cut_activation_size(CNNConfig(), 1, c),
               lambda c: cnn.client_block_flops(CNNConfig(), 1, c)):
        with pytest.raises(ValueError, match="unknown cut"):
            fn("conv3")
