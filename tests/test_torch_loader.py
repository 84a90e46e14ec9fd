"""Port parity for the mini-batch loaders (``repro_torch.data.loader``) and
the Genie baseline (``repro_torch.core.fedsim.centralized_sgd``) against
the reference's.

- ``ClientLoader`` and ``batch_iterator`` give the reference's batches,
  index for index (the same numpy streams).
- ``centralized_sgd`` on a small CNN, from the reference's initial
  parameters (carried in by patching the port's ``cnn.init`` inside the
  test), gives the reference's accuracy and its loss within 1e-4
  relative.
"""

import numpy as np
import pytest

import jax

from repro.configs.base import TrainConfig as JT
from repro.configs.phsfl_cnn import CNNConfig as JCNNConfig
from repro.core.fedsim import centralized_sgd as j_centralized
from repro.data.loader import ClientLoader as JLoader
from repro.data.loader import batch_iterator as j_batches
from repro.data.synthetic import make_federated_image_data as j_data
from repro.models import cnn as j_cnn
from repro_torch.configs import CNNConfig, TrainConfig
from repro_torch.convert import params_from_numpy
from repro_torch.core.fedsim import centralized_sgd
from repro_torch.data import ClientLoader, batch_iterator
from repro_torch.data.synthetic import make_federated_image_data
from repro_torch.models import cnn

SMALL = dict(image_size=16, conv1_filters=8, conv2_filters=16, fc_hidden=32)
DATA = dict(image_size=16, train_per_class=30, test_per_class=10, seed=0)


@pytest.mark.parametrize("n,batch,seed", [(50, 8, 0), (5, 8, 3),
                                          (33, 33, 7)])
def test_client_loader_matches_reference(n, batch, seed):
    x = np.arange(n * 2, dtype=np.float32).reshape(n, 2)
    y = np.arange(n, dtype=np.int32)
    a, b = ClientLoader(x, y, batch, seed), JLoader(x, y, batch, seed)
    for _ in range(4):
        for got, want in zip(a.next_batch(), b.next_batch()):
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n,batch,seed,epochs", [(50, 8, 0, 2),
                                                 (17, 4, 5, 3),
                                                 (8, 16, 1, 1)])
def test_batch_iterator_matches_reference(n, batch, seed, epochs):
    x = np.random.default_rng(9).normal(size=(n, 3)).astype(np.float32)
    y = np.arange(n, dtype=np.int32)
    got = list(batch_iterator(x, y, batch, seed=seed, epochs=epochs))
    want = list(j_batches(x, y, batch, seed=seed, epochs=epochs))
    assert len(got) == len(want) == epochs * (n // batch)
    for (gx, gy), (wx, wy) in zip(got, want):
        np.testing.assert_array_equal(gx, wx)
        np.testing.assert_array_equal(gy, wy)
    if n >= batch:                  # epochs=None: passes without end
        endless = batch_iterator(x, y, batch, seed=seed)
        more = [next(endless) for _ in range(len(got) + 1)]
        for (gx, _), (wx, _) in zip(more, got):
            np.testing.assert_array_equal(gx, wx)


def test_centralized_sgd_matches_reference(monkeypatch):
    epochs, seed = 2, 0
    tcfg = dict(learning_rate=0.05, batch_size=16)
    data = make_federated_image_data(4, 0.5, **DATA)
    j_params, want = j_centralized(JCNNConfig(**SMALL),
                                   j_data(4, 0.5, **DATA), JT(**tcfg),
                                   epochs=epochs, seed=seed)
    init = jax.tree.map(np.asarray,
                        j_cnn.init(jax.random.PRNGKey(seed),
                                   JCNNConfig(**SMALL)))
    calls = []

    def reference_init(s, cfg, dtype=None, device="cpu"):
        calls.append(s)
        return params_from_numpy(init, device)

    monkeypatch.setattr(cnn, "init", reference_init)
    params, got = centralized_sgd(CNNConfig(**SMALL), data,
                                  TrainConfig(**tcfg), epochs=epochs,
                                  seed=seed, device="cpu")
    assert calls == [seed]
    assert got["acc"] == want["acc"]
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-4)
    assert 0.0 <= got["acc"] <= 1.0 and np.isfinite(got["loss"])
    for k in init:
        for n in init[k]:
            np.testing.assert_allclose(params[k][n].numpy(),
                                       np.asarray(j_params[k][n]),
                                       rtol=1e-4, atol=1e-5,
                                       err_msg=f"{k}/{n}")
