"""Mini-batch iterators for the federated simulation and the centralized
baseline (the port's copy of ``repro.data.loader``).

numpy only, on the host, with the reference's ``default_rng(seed)``
streams: the same seed gives the same batches, index for index.
"""

from __future__ import annotations

import numpy as np


class ClientLoader:
    """Cyclic mini-batch sampler over one client's local dataset.

    The paper's Step 3.2: each client uniformly samples N-sized mini-batches;
    sampled indices are offloaded to the ES along with the activations (the
    ES holds the labels).
    """

    def __init__(self, x: np.ndarray, y: np.ndarray, batch_size: int,
                 seed: int):
        assert len(x) == len(y) and len(x) > 0
        self.x, self.y = x, y
        self.batch_size = batch_size
        self.rng = np.random.default_rng(seed)

    def next_batch(self):
        n = len(self.x)
        idx = self.rng.choice(n, size=min(self.batch_size, n),
                              replace=n < self.batch_size)
        return self.x[idx], self.y[idx], idx


def batch_iterator(x: np.ndarray, y: np.ndarray, batch_size: int,
                   seed: int = 0, epochs: int | None = None):
    """Epoch-shuffled full passes (for the centralized Genie baseline)."""
    rng = np.random.default_rng(seed)
    epoch = 0
    while epochs is None or epoch < epochs:
        perm = rng.permutation(len(x))
        for i in range(0, len(x) - batch_size + 1, batch_size):
            sl = perm[i:i + batch_size]
            yield x[sl], y[sl]
        epoch += 1
