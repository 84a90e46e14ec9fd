"""Port parity: the port's numpy copies of the data modules give arrays
equal to ``repro.data`` for the same seed (exact: both are the same numpy
code on the same seed)."""

import numpy as np
import pytest

from repro.data import dirichlet as jdir
from repro.data import synthetic as jsyn
from repro_torch.data import dirichlet as tdir
from repro_torch.data import synthetic as tsyn


@pytest.mark.parametrize("seed", [0, 3])
def test_image_dataset_equal(seed):
    kw = dict(num_classes=10, image_size=16, channels=3, train_per_class=12,
              test_per_class=5, seed=seed)
    a, b = jsyn.make_image_dataset(**kw), tsyn.make_image_dataset(**kw)
    for f in ("x_train", "y_train", "x_test", "y_test"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        assert getattr(a, f).dtype == getattr(b, f).dtype
    assert a.num_classes == b.num_classes


@pytest.mark.parametrize("alpha", [0.1, 0.5, 100.0])
def test_dirichlet_partition_equal(alpha):
    labels = np.random.default_rng(1).integers(0, 10, size=400)
    a = jdir.dirichlet_partition(labels, 8, alpha, seed=5)
    b = tdir.dirichlet_partition(labels, 8, alpha, seed=5)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    prop_a = jdir.class_proportions(labels, a, 10)
    prop_b = tdir.class_proportions(labels, b, 10)
    np.testing.assert_array_equal(prop_a, prop_b)
    for x, y in zip(jdir.partition_like(labels, prop_a, seed=2),
                    tdir.partition_like(labels, prop_b, seed=2)):
        np.testing.assert_array_equal(x, y)


def test_dirichlet_starved_clients_top_up_equal():
    # tiny data at extreme skew takes the top-up fallback on both sides
    labels = np.repeat(np.arange(4), 3)
    a = jdir.dirichlet_partition(labels, 5, 0.01, seed=0, min_per_client=2)
    b = tdir.dirichlet_partition(labels, 5, 0.01, seed=0, min_per_client=2)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def test_federated_image_data_equal():
    kw = dict(num_classes=10, image_size=16, train_per_class=20,
              test_per_class=6, seed=2)
    a = jsyn.make_federated_image_data(6, 0.4, **kw)
    b = tsyn.make_federated_image_data(6, 0.4, **kw)
    assert a.num_clients == b.num_clients == 6
    assert a.alpha == b.alpha
    np.testing.assert_array_equal(a.client_weights(), b.client_weights())
    for u in range(6):
        for part in ("client_train", "client_test"):
            (xa, ya), (xb, yb) = getattr(a, part)(u), getattr(b, part)(u)
            np.testing.assert_array_equal(xa, xb)
            np.testing.assert_array_equal(ya, yb)
