"""The token feed: each client's batches drawn from a seed.

A copy of the port's ``launch.train._client_round_batch`` token streams
(non-IID clients: client c's tokens are shifted by c * V / (2C) in a
vocabulary of V), element for element, so that the benchmark's inputs
do not move when the program's generator is edited.  Each client draws
a Markov-like stream from ``numpy.random.default_rng(seed * 1000 + c)``
over half the vocabulary: every other token is the previous one plus 1.
Labels are the tokens shifted left by one, wrapping.

Frame embeddings for the encoder-decoder's stubbed speech frontend are
drawn on the device from a generator seeded apart, N(0, 1), in the
model's dtype.
"""

from __future__ import annotations

import numpy as np
import torch


def token_stream(seed: int, batch: int, seq: int, vocab: int) -> tuple:
    r = np.random.default_rng(seed)
    base = r.integers(0, vocab, size=(batch, seq), dtype=np.int32)
    base[:, 1::2] = (base[:, 0:-1:2] + 1) % vocab
    return base, np.roll(base, -1, axis=1)


def client_tokens(vocab: int, clients: int, lead: tuple, seq: int,
                  seed: int) -> dict:
    """{"tokens", "labels"}: int32 numpy arrays (clients, *lead, seq)."""
    n = int(np.prod(lead))
    toks, labs = [], []
    for c in range(clients):
        t, lb = token_stream(seed * 1000 + c, n, seq, max(vocab // 2, 2))
        shift = (c * vocab) // (2 * max(clients, 1))
        toks.append((t + shift) % vocab)
        labs.append((lb + shift) % vocab)
    shape = (clients, *lead, seq)
    return {"tokens": np.stack(toks).reshape(shape),
            "labels": np.stack(labs).reshape(shape)}


def frames(shape: tuple, seed: int, dtype, device) -> torch.Tensor:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    out = torch.empty(shape, dtype=dtype, device=device)
    return out.normal_(generator=gen)


def to_device(batch: dict, device) -> dict:
    return {k: torch.from_numpy(v).to(device) if isinstance(v, np.ndarray)
            else v for k, v in batch.items()}
