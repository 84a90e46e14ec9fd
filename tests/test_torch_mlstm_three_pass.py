"""The bf16 mLSTM kernel's scheme on the CPU: ``ref.mlstm_three_pass``
(gates, chunk-boundary states every 256 rows stored as bf16 hi/lo planes,
outputs over 64-row tiles with P split into hi and lo) against the JAX
reference's Pallas kernel in interpret mode where S is a multiple of its
chunk, against the port's recurrent oracle at ragged lengths, and against
the reference's ``mlstm_ref`` at full length and width, on the same
numpy-made bf16 inputs.

Tolerance: the kernel's check on the card, ``chip_smoke.MLSTM_TOL`` for
bfloat16 (rtol 2^-7, atol 2e-4): both sides compute in float32 and round
the output to bf16 once, so a row can differ by one bf16 step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.mlstm_chunk.kernel import mlstm_chunk_pallas
from repro.kernels.mlstm_chunk.ref import mlstm_ref as j_ref
from repro_torch.hopper.mlstm_chunk.ref import (STATE_CHUNK, TILE,
                                                mlstm_recurrent_ref,
                                                mlstm_three_pass)

RTOL, ATOL = 2.0 ** -7, 2e-4


def _inputs(b, h, s, dh, seed=0):
    """Head-major q, k, v (B,H,S,dh) rounded to bf16 and float32 gates
    (B,H,S), drawn as the reference's sweep draws them."""
    r = np.random.default_rng(seed)
    bf = lambda a: np.array(jnp.asarray(a).astype(jnp.bfloat16)  # noqa
                              .astype(jnp.float32))
    q = bf(r.normal(size=(b, h, s, dh)))
    k = bf(r.normal(size=(b, h, s, dh)) / np.sqrt(dh))
    v = bf(r.normal(size=(b, h, s, dh)))
    li = r.normal(size=(b, h, s)).astype(np.float32)
    lf = np.array(jax.nn.log_sigmoid(
        jnp.asarray(r.normal(size=(b, h, s)).astype(np.float32))))
    return q, k, v, li, lf


def _emulate(q, k, v, li, lf):
    """The scheme in the model's layout, bf16 q, k, v; back head-major."""
    sw = lambda a: torch.from_numpy(  # noqa: E731
        np.ascontiguousarray(np.swapaxes(a, 1, 2)))
    out = mlstm_three_pass(*(sw(a).to(torch.bfloat16) for a in (q, k, v)),
                           sw(li), sw(lf))
    assert out.dtype == torch.bfloat16
    return out.float().transpose(1, 2).numpy()


def _close(got, want):
    np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=RTOL,
                               atol=ATOL)


def test_scheme_constants():
    assert (STATE_CHUNK, TILE) == (256, 64)


@pytest.mark.parametrize("b,h,s,dh", [(1, 2, 256, 32), (2, 1, 512, 16),
                                      (1, 1, 512, 64)])
def test_three_pass_matches_pallas_interpret(b, h, s, dh):
    """S a multiple of the Pallas kernel's chunk (128): one state chunk,
    and two with a boundary state between them."""
    x = _inputs(b, h, s, dh, seed=s + dh)
    want = mlstm_chunk_pallas(
        *(jnp.asarray(a).astype(jnp.bfloat16) for a in x[:3]),
        *map(jnp.asarray, x[3:]))
    _close(_emulate(*x), jnp.asarray(want).astype(jnp.float32))


@pytest.mark.parametrize("s", [255, 257, 513])
def test_three_pass_matches_recurrent_oracle_at_ragged_lengths(s):
    """A ragged last state chunk and last tile (one row past a boundary,
    one short of one), against the step-by-step oracle in float32 on the
    same bf16-valued inputs."""
    x = _inputs(1, 2, s, 32, seed=s)
    want = mlstm_recurrent_ref(*map(torch.from_numpy, x))
    _close(_emulate(*x), want.numpy())


def test_three_pass_matches_reference_at_full_width():
    """One head of the xlstm-350m serving shape, (1, 2048, 1, 512) bf16:
    seven boundary states, against the reference's mlstm_ref in bf16."""
    x = _inputs(1, 1, 2048, 512, seed=7)
    want = j_ref(*(jnp.asarray(a).astype(jnp.bfloat16) for a in x[:3]),
                 *map(jnp.asarray, x[3:]))
    _close(_emulate(*x), jnp.asarray(want).astype(jnp.float32))


def _tol_ratio(got, want):
    """The worst |got - want| / (ATOL + RTOL |want|): <= 1 passes."""
    want = np.asarray(want, np.float64)
    return float((np.abs(np.asarray(got, np.float64) - want)
                  / (ATOL + RTOL * np.abs(want))).max())


def test_float64_witness_at_a_long_ragged_length():
    """Why the card check holds its S = 2049 tile-edge cases against the
    plain version on zero rows padded to its chunk of 128: the plain
    version at a ragged S takes one quadratic chunk, whose float32 cumsum
    of the forget gates over all 2049 rows drifts from the float64
    recurrent oracle by more than a bf16 step, while the padded plain
    version and the scheme stay within the tolerance of that oracle, on
    the same bf16-valued inputs at (1, 2049, 2, 256)."""
    from repro_torch.hopper.mlstm_chunk.ref import (KERNEL_CHUNK,
                                                    mlstm_chunkwise)
    s = 2049
    x = _inputs(1, 2, s, 256, seed=s)
    oracle = mlstm_recurrent_ref(*(torch.from_numpy(a).double() for a in x),
                                 dtype=torch.float64).numpy()
    sw = lambda a: torch.from_numpy(  # noqa: E731
        np.ascontiguousarray(np.swapaxes(a, 1, 2)))
    qkv = [sw(a).to(torch.bfloat16) for a in x[:3]]
    gates = [sw(a) for a in x[3:]]

    def plain(args):
        h = mlstm_chunkwise(*args, chunk=KERNEL_CHUNK)[0][:, :s]
        return h.float().transpose(1, 2).numpy()

    pad = -s % KERNEL_CHUNK
    padded = [torch.nn.functional.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
              for t in qkv + gates]
    assert _tol_ratio(plain(padded), oracle) <= 1.0
    assert _tol_ratio(_emulate(*x), oracle) <= 1.0
    assert _tol_ratio(plain(qkv + gates), oracle) > 1.0
