"""Synthetic datasets.

The repository ships no CIFAR-10; the paper-validation experiments use a
class-conditional synthetic image dataset that preserves the *structure* that
PHSFL exploits: all classes share low-level feature statistics (the paper's
"many of the features have similar attributes"), while class identity lives
in a lower-dimensional signal subspace.  Accuracy numbers are therefore not
directly comparable to CIFAR-10, but every distributional claim
(generalized vs personalized, Dir(0.1) vs Dir(0.5), PHSFL vs HSFL) is
evaluated on identical footing across algorithms.

A numpy copy of ``repro.data.synthetic``: the same seed gives the same
arrays on both sides.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.data.dirichlet import dirichlet_partition


@dataclass
class SyntheticImageDataset:
    x_train: np.ndarray          # (N, H, W, C) float32
    y_train: np.ndarray          # (N,) int32
    x_test: np.ndarray
    y_test: np.ndarray
    num_classes: int


def make_image_dataset(num_classes: int = 10, image_size: int = 32,
                       channels: int = 3, train_per_class: int = 500,
                       test_per_class: int = 100, signal_rank: int = 24,
                       noise: float = 0.35, seed: int = 0) -> SyntheticImageDataset:
    """Class-conditional Gaussian images with a shared feature basis.

    x = B @ z_c + eps, where B is a (D, signal_rank) basis shared across all
    classes (the "similar attributes"), z_c ~ N(mu_c, I) a class-specific
    latent, eps pixel noise.  A linear probe on the shared features separates
    classes well; pixels alone do not — mirroring body-learns-features /
    head-learns-classes.
    """
    rng = np.random.default_rng(seed)
    d = image_size * image_size * channels
    basis = rng.normal(0, 1.0 / np.sqrt(signal_rank), size=(d, signal_rank))
    mus = rng.normal(0, 1.6, size=(num_classes, signal_rank))

    def sample(per_class: int, salt: int):
        r = np.random.default_rng(seed + salt)
        xs, ys = [], []
        for c in range(num_classes):
            z = r.normal(0, 1, size=(per_class, signal_rank)) + mus[c]
            x = z @ basis.T + r.normal(0, noise, size=(per_class, d))
            xs.append(x)
            ys.append(np.full(per_class, c))
        x = np.concatenate(xs).astype(np.float32)
        y = np.concatenate(ys).astype(np.int32)
        perm = r.permutation(len(y))
        x = x[perm].reshape(-1, image_size, image_size, channels)
        return x, y[perm]

    x_train, y_train = sample(train_per_class, salt=1)
    x_test, y_test = sample(test_per_class, salt=2)
    return SyntheticImageDataset(x_train, y_train, x_test, y_test, num_classes)


@dataclass
class FederatedImageData:
    dataset: SyntheticImageDataset
    train_indices: list[np.ndarray]   # per client
    test_indices: list[np.ndarray]    # per client
    alpha: float

    @property
    def num_clients(self) -> int:
        return len(self.train_indices)

    def client_train(self, u: int):
        idx = self.train_indices[u]
        return self.dataset.x_train[idx], self.dataset.y_train[idx]

    def client_test(self, u: int):
        idx = self.test_indices[u]
        return self.dataset.x_test[idx], self.dataset.y_test[idx]

    def client_weights(self) -> np.ndarray:
        """alpha_u proportional to |D_u| (paper Eq. 4)."""
        sizes = np.array([len(i) for i in self.train_indices], dtype=np.float64)
        return sizes / sizes.sum()


def make_federated_image_data(num_clients: int, alpha: float, *,
                              num_classes: int = 10, image_size: int = 32,
                              train_per_class: int = 500,
                              test_per_class: int = 100,
                              seed: int = 0) -> FederatedImageData:
    """Paper Sec. V-A setup: both train and test are Dirichlet-partitioned with
    the *same* per-client class profile (so personalization has a target)."""
    from repro_torch.data.dirichlet import class_proportions, partition_like

    ds = make_image_dataset(num_classes=num_classes, image_size=image_size,
                            train_per_class=train_per_class,
                            test_per_class=test_per_class, seed=seed)
    tr = dirichlet_partition(ds.y_train, num_clients, alpha, seed=seed + 10)
    # each client's TEST set matches its TRAIN class profile (the paper's
    # personalization setup: w_u^K is evaluated on the client's own
    # distribution)
    prop = class_proportions(ds.y_train, tr, num_classes)
    te = partition_like(ds.y_test, prop, seed=seed + 11)
    return FederatedImageData(ds, tr, te, alpha)


def synthetic_token_batch(rng: np.ndarray | int, batch: int, seq_len: int,
                          vocab: int) -> dict[str, np.ndarray]:
    """Markov-ish synthetic token stream for LM smoke tests."""
    r = np.random.default_rng(rng)
    base = r.integers(0, vocab, size=(batch, seq_len), dtype=np.int32)
    # induce local correlation: every other token repeats previous +1 mod vocab
    base[:, 1::2] = (base[:, 0:-1:2] + 1) % vocab
    return {"tokens": base, "labels": np.roll(base, -1, axis=1)}
