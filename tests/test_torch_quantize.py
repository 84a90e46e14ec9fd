"""Port parity for the quantize kernel K1: the port's plain version against
the JAX reference's oracle and its Pallas kernel (interpret mode), both
eager, on the same numpy-made (x, u).

Tolerance: none.  Both sides do the same float32 operations (a separate
multiply and add, floor, clip, multiply), so the results are array-equal,
as the reference's own kernel-vs-oracle test requires.  The one known
exception lies on the JAX side and is pinned down in
``test_plain_matches_jax_pallas_interpret``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.quantize.kernel import LANES, quantize_dequantize_pallas
from repro.kernels.quantize.ops import tensor_scale as jax_tensor_scale
from repro.kernels.quantize.ref import quantize_dequantize_ref as jax_ref
from repro_torch.hopper.quantize import kernel, ops
from repro_torch.hopper.quantize.ref import quantize_dequantize_ref

SHAPES = [(7,), (16, 16, 16, 64), (3, 5, 11)]
BITS = list(range(2, 9))


def _inputs(shape, u_mode, seed=0):
    r = np.random.default_rng(seed)
    if u_mode == "zero_x":
        x = np.zeros(shape, np.float32)
    else:
        x = (r.normal(size=shape) * 3.0).astype(np.float32)
    if u_mode == "half":
        u = np.full(shape, 0.5, np.float32)
    else:
        u = r.random(size=shape, dtype=np.float32)
    return x, u


def _port(x, u, bits):
    qmax = 2 ** (bits - 1) - 1
    xt = torch.from_numpy(x.reshape(1, -1))
    scale = ops.tensor_scale(xt, qmax)
    out = ops.quantize_dequantize(xt, torch.from_numpy(u.reshape(1, -1)),
                                  scale, qmax)
    return out.numpy().reshape(x.shape), scale.numpy()[0]


def _jax_scale(x, bits):
    return jax_tensor_scale(jnp.asarray(x), 2 ** (bits - 1) - 1)


@pytest.mark.parametrize("u_mode", ["stochastic", "half", "zero_x"])
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("bits", BITS)
def test_plain_matches_jax_ref(bits, shape, u_mode):
    x, u = _inputs(shape, u_mode)
    got, scale = _port(x, u, bits)
    js = _jax_scale(x, bits)
    assert scale == np.asarray(js)[0, 0]           # the same step size
    want = jax_ref(jnp.asarray(x), jnp.asarray(u), js[0, 0],
                   2 ** (bits - 1) - 1)
    np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("u_mode", ["stochastic", "half"])
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("bits", BITS)
def test_plain_matches_jax_pallas_interpret(bits, shape, u_mode):
    """Array-equal to the Pallas kernel, but for one known effect on the
    JAX side: ``quantize_dequantize_pallas`` is jitted, and XLA compiles
    the body's ``x * inv + u`` with other roundings than the eager ops
    (the reference's own test_compress.py notes the same drift under an
    outer jit).  Where the compiled result departs from JAX's eager
    oracle, the sum ``x * inv + u`` lies within a few ulps of an integer,
    and the port there equals the eager oracle: it sides with the eager
    arithmetic, as the CUDA kernel does."""
    x, u = _inputs(shape, u_mode, seed=1)
    got, _ = _port(x, u, bits)
    qmax = 2 ** (bits - 1) - 1
    js = _jax_scale(x, bits)
    n = x.size
    block_m = 256 if n >= 256 * LANES else 8        # as the reference's ops
    pad = (-n) % (block_m * LANES)
    xp = jnp.pad(jnp.asarray(x.reshape(-1)), (0, pad)).reshape(-1, LANES)
    up = jnp.pad(jnp.asarray(u.reshape(-1)), (0, pad)).reshape(-1, LANES)
    pallas = np.asarray(quantize_dequantize_pallas(
        xp, up, js, qmax=qmax, block_m=block_m,
        interpret=True)).reshape(-1)[:n].reshape(x.shape)
    eager = np.asarray(jax_ref(jnp.asarray(x), jnp.asarray(u), js[0, 0],
                               qmax))
    drift = pallas != eager
    s = np.asarray(js)[0, 0]
    inv = np.float32(1.0) / s if s > 0 else np.float32(0.0)
    v = (x * inv).astype(np.float32) + u
    near = np.abs(v - np.round(v)) <= 4 * np.spacing(np.abs(v))
    assert not (drift & ~near).any()
    np.testing.assert_array_equal(got[~drift], pallas[~drift])
    np.testing.assert_array_equal(got[drift], eager[drift])


def test_zero_row_stays_zero_and_scale_is_zero():
    x = torch.zeros(2, 9)
    x[1] = torch.arange(9.0) - 4.0
    scale = ops.tensor_scale(x, 4)                   # row 1: a step of 1
    assert scale[0] == 0.0 and scale[1] == 1.0
    out = ops.quantize_dequantize(x, torch.full_like(x, 0.5), scale, 4)
    assert torch.equal(out[0], torch.zeros(9))
    # a row whose values sit on the grid comes back unchanged
    assert torch.equal(out[1], x[1])


def test_ste_gradient_is_exactly_ones_and_skips_scale():
    r = np.random.default_rng(2)
    x = torch.from_numpy(r.normal(size=(3, 40)).astype(np.float32))
    x.requires_grad_(True)
    u = torch.from_numpy(r.random(size=(3, 40), dtype=np.float32))
    u.requires_grad_(True)
    # the scale is computed from x inside the graph: had the wrapper let a
    # gradient through it, x.grad would differ from ones
    scale = ops.tensor_scale(x, 127)
    out = ops.quantize_dequantize(x, u, scale, 127)
    (g_x, g_u) = torch.autograd.grad(out.sum(), [x, u], allow_unused=True)
    assert torch.equal(g_x, torch.ones_like(x))
    assert g_u is None


def test_codec_entry_ste_through_any_shape():
    x = torch.randn(2, 4, 5, 3, requires_grad=True)
    out = ops.quantize_rows(x, torch.Generator().manual_seed(0), bits=4)
    assert out.shape == x.shape
    out.sum().backward()
    assert torch.equal(x.grad, torch.ones_like(x))


def test_batched_rows_equal_single_calls():
    r = np.random.default_rng(3)
    rows = [(r.normal(size=50) * s).astype(np.float32) for s in (1, 7, 0.1)]
    rows[1][4] = 0.0
    x = torch.from_numpy(np.stack(rows))
    u = torch.from_numpy(r.random(size=x.shape, dtype=np.float32))
    batched = ops.quantize_dequantize(x, u, ops.tensor_scale(x, 7), 7)
    for i in range(3):
        single = ops.quantize_dequantize(
            x[i:i + 1], u[i:i + 1], ops.tensor_scale(x[i:i + 1], 7), 7)
        assert torch.equal(batched[i:i + 1], single)
    # each row got its own scale: the small row is not crushed to zero
    assert batched[2].abs().max() > 0


def test_quantize_rows_deterministic_mode_ignores_generator():
    x = torch.randn(3, 64)
    a = ops.quantize_rows(x, None, bits=8, stochastic=False)
    b = ops.quantize_rows(x, torch.Generator().manual_seed(9), bits=8,
                          stochastic=False)
    assert torch.equal(a, b)
    s = ops.tensor_scale(x, 127)
    want = quantize_dequantize_ref(x, torch.full_like(x, 0.5), s, 127)
    assert torch.equal(a, want)


@pytest.mark.parametrize("bad", ["dtype", "shape_u", "shape_scale", "rank",
                                 "noncontig"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    x = torch.randn(4, 8)
    u = torch.rand(4, 8)
    s = ops.tensor_scale(x, 127)
    if bad == "dtype":
        x = x.double()
    elif bad == "shape_u":
        u = u[:, :4]
    elif bad == "shape_scale":
        s = s[:2]
    elif bad == "rank":
        x, u = x[None], u[None]
    else:
        x = torch.randn(8, 4).t()                   # (4, 8), not contiguous
    with pytest.raises((TypeError, ValueError)):
        ops.quantize_dequantize(x, u, s, 127)


def test_kernel_module_imports_without_nvcc():
    # importing and dispatching CPU tensors never builds or loads the
    # CUDA library; the build happens at the first CUDA launch
    assert kernel._lib is None
    x = torch.randn(2, 16)
    ops.quantize_rows(x, torch.Generator().manual_seed(0))
    assert kernel._lib is None
    assert kernel.launches == 0
    assert kernel.library_path().name.startswith("libquantize_")
    assert kernel.SOURCE.exists()
    assert "arch=compute_90a,code=sm_90a" in kernel.NVCC_FLAGS
    assert "--use_fast_math" not in kernel.NVCC_FLAGS
