"""RNG stream state as a plain array (``repro.checkpoint.ckpt``'s
``rng_state_array``/``restore_rng_state``, copied).

A numpy PCG64 ``Generator``'s exact stream position round-trips through a
(6,) uint64 array, so RNG streams checkpoint like any other leaf, and a
state written by the reference restores here (``checkpoint/ckpt.py``
writes and reads such trees).
"""

from __future__ import annotations

import numpy as np

_MASK64 = (1 << 64) - 1


def rng_state_array(rng: np.random.Generator) -> np.ndarray:
    """A PCG64 Generator's exact state as a (6,) uint64 array.

    Layout: [state_hi, state_lo, inc_hi, inc_lo, has_uint32, uinteger] —
    the 128-bit state/inc words split into 64-bit halves."""
    st = rng.bit_generator.state
    if st["bit_generator"] != "PCG64":
        raise TypeError(f"expected a PCG64 generator, got "
                        f"{st['bit_generator']}")
    s, inc = st["state"]["state"], st["state"]["inc"]
    return np.array([s >> 64, s & _MASK64, inc >> 64, inc & _MASK64,
                     st["has_uint32"], st["uinteger"]], dtype=np.uint64)


def restore_rng_state(rng: np.random.Generator, arr) -> None:
    """Restore a Generator's stream position from ``rng_state_array``."""
    a = [int(x) for x in np.asarray(arr, np.uint64)]
    if len(a) != 6:
        raise ValueError(f"expected a (6,) rng state array, got "
                         f"shape {np.asarray(arr).shape}")
    rng.bit_generator.state = {
        "bit_generator": "PCG64",
        "state": {"state": (a[0] << 64) | a[1], "inc": (a[2] << 64) | a[3]},
        "has_uint32": a[4], "uinteger": a[5]}
