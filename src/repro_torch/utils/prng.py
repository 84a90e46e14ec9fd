"""Seed streams as ``torch.Generator``s.

JAX derives keys (``split``, ``fold_in``) and samplers consume them; torch
draws from stateful generators.  The port derives integer seeds the way
JAX derives keys and seeds one generator from each, so a named stream
depends only on its parent seed and its name.  ``fold_in_str`` keeps the
reference's string hash (``repro.utils.prng.fold_in_str``), so each leaf
of the client-block offload draws from a stream of its own.

The two frameworks' generators give different numbers from the same
seed: parity tests hand both sides the same numpy-made noise instead.
"""

from __future__ import annotations

import itertools

import torch

_MASK64 = (1 << 64) - 1
SEED_BITS = 62          # drawn seeds stay well inside torch's int64 range


def fold_in(seed: int, data: int) -> int:
    """A new seed from ``seed`` and an integer datum (splitmix64 mix)."""
    z = (int(seed) * 0x9E3779B97F4A7C15 + int(data) + 1) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (z ^ (z >> 31)) >> (64 - SEED_BITS)


def key_iter(seed: int):
    """Infinite iterator of fresh seeds: ``fold_in(seed, 0)``,
    ``fold_in(seed, 1)``, ...

    The reference yields jax keys split off a chain; a jax key is not a
    torch generator, so the port yields integer seeds by its own
    ``fold_in`` convention instead (``make_generator`` seeds a generator
    from one).  The same seed gives the same stream; the two packages'
    streams differ."""
    for i in itertools.count():
        yield fold_in(seed, i)


def str_hash(name: str) -> int:
    """The reference's stable string hash (``fold_in_str``'s datum)."""
    h = 0
    for ch in name:
        h = (h * 131 + ord(ch)) % (2**31 - 1)
    return h


def fold_in_str(seed: int, name: str) -> int:
    """Deterministically derive a seed from a string (stable across runs)."""
    return fold_in(seed, str_hash(name))


def make_generator(seed: int, device="cpu") -> torch.Generator:
    """A generator on ``device`` seeded with ``seed``."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    return g


def draw_seed(gen: torch.Generator) -> int:
    """The next seed of a CPU seed chain (JAX: ``split`` of a chain key)."""
    return int(torch.randint(0, 2**SEED_BITS, (1,), generator=gen))
