"""Dirichlet non-IID partitioner (the paper's data-distribution strategy [4]).

Samples of each class are split across clients with proportions drawn from a
symmetric Dirichlet(alpha): small alpha => highly skewed (each client sees few
classes), large alpha => near-IID.

A numpy copy of ``repro.data.dirichlet``: the same seed gives the same
partition on both sides.
"""

from __future__ import annotations

import numpy as np


def dirichlet_partition(labels: np.ndarray, num_clients: int, alpha: float,
                        seed: int = 0, min_per_client: int = 2) -> list[np.ndarray]:
    """Return per-client index arrays; every sample assigned exactly once.

    Retries the draw until every client has >= min_per_client samples so the
    downstream per-client fine-tuning/eval is well-defined (standard practice).
    """
    rng = np.random.default_rng(seed)
    labels = np.asarray(labels)
    classes = np.unique(labels)
    n = len(labels)
    for _attempt in range(25):
        client_indices: list[list[int]] = [[] for _ in range(num_clients)]
        for c in classes:
            idx = np.flatnonzero(labels == c)
            rng.shuffle(idx)
            props = rng.dirichlet(np.full(num_clients, alpha))
            # split points proportional to the draw
            cuts = (np.cumsum(props) * len(idx)).astype(int)[:-1]
            for client, part in enumerate(np.split(idx, cuts)):
                client_indices[client].extend(part.tolist())
        sizes = np.array([len(ci) for ci in client_indices])
        if sizes.min() >= min_per_client:
            break
    else:
        # top-up fallback (standard practice at extreme skew): move random
        # samples from the largest clients to the starved ones.  The donor
        # must never be the starved client itself (argmax can land on it
        # when every client is tiny, which used to move samples nowhere and
        # loop forever), and sizes are recomputed after every single move so
        # a drained donor stops being picked.
        for u in range(num_clients):
            while len(client_indices[u]) < min_per_client:
                sizes = np.array([len(ci) if i != u else -1
                                  for i, ci in enumerate(client_indices)])
                donor = int(np.argmax(sizes))
                if sizes[donor] <= min_per_client:
                    raise ValueError(
                        f"cannot satisfy min_per_client={min_per_client}: "
                        f"{len(labels)} samples over {num_clients} clients")
                take = client_indices[donor].pop(
                    rng.integers(len(client_indices[donor])))
                client_indices[u].append(take)
    out = [np.array(sorted(ci), dtype=np.int64) for ci in client_indices]
    assert sum(len(o) for o in out) == n
    return out


def class_proportions(labels: np.ndarray, parts: list[np.ndarray],
                      num_classes: int) -> np.ndarray:
    """(num_clients, num_classes) per-client class shares of a partition."""
    labels = np.asarray(labels)
    prop = np.zeros((len(parts), num_classes))
    for u, idx in enumerate(parts):
        cnt = np.bincount(labels[idx], minlength=num_classes)
        prop[u] = cnt
    col = prop.sum(axis=0, keepdims=True)
    col[col == 0] = 1.0
    return prop / col          # share of each CLASS owned by each client


def partition_like(labels: np.ndarray, proportions: np.ndarray,
                   seed: int = 0) -> list[np.ndarray]:
    """Partition ``labels`` so client u receives ``proportions[u, c]`` of
    class c — used to give each client a TEST set matching its train
    distribution (the paper's setup: personalization targets the client's
    own distribution)."""
    rng = np.random.default_rng(seed)
    labels = np.asarray(labels)
    num_clients, num_classes = proportions.shape
    client_indices: list[list[int]] = [[] for _ in range(num_clients)]
    for c in range(num_classes):
        idx = np.flatnonzero(labels == c)
        rng.shuffle(idx)
        cuts = (np.cumsum(proportions[:, c]) * len(idx)).astype(int)[:-1]
        for u, part in enumerate(np.split(idx, cuts)):
            client_indices[u].extend(part.tolist())
    return [np.array(sorted(ci), dtype=np.int64) for ci in client_indices]
