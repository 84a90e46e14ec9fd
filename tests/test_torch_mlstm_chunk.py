"""Port parity for the mLSTM chunk kernel K3 on the CPU: the port's plain
version (``ref.py``, the path a CPU tensor takes) against the JAX
reference's Pallas kernel in interpret mode and its oracles, on the same
numpy-made q, k, v and gates; the wrapper's value and gradient against
``jax.vjp`` of the reference's ``mlstm_ref``.

Tolerances: the reference's own 2e-4 (tests/test_kernels.py:104) in
float32 (summation order, and the cumsum of the forget gates inside a
chunk); for bfloat16 inputs, one bfloat16 step (2^-7 relative) on top of
it, since both sides compute in float32 and round the output once.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.mlstm_chunk.kernel import mlstm_chunk_pallas
from repro.kernels.mlstm_chunk.ref import mlstm_recurrent_ref as j_rec
from repro.kernels.mlstm_chunk.ref import mlstm_ref as j_ref
from repro.models.xlstm import mlstm_chunkwise as j_chunkwise
from repro_torch.hopper.mlstm_chunk import kernel, ops
from repro_torch.hopper.mlstm_chunk.ref import mlstm_recurrent_ref, mlstm_ref
from repro_torch.models.xlstm import MLSTM_CHUNK, mlstm_chunkwise

TOL = 2e-4
BF16_RTOL = 2.0 ** -7


def _inputs(b, h, s, dh, seed=0):
    """Head-major q, k, v (B,H,S,dh) and gates (B,H,S), drawn as the
    reference's sweep draws them (tests/test_kernels.py:94-99)."""
    r = np.random.default_rng(seed)
    q = r.normal(size=(b, h, s, dh)).astype(np.float32)
    k = (r.normal(size=(b, h, s, dh)) / np.sqrt(dh)).astype(np.float32)
    v = r.normal(size=(b, h, s, dh)).astype(np.float32)
    li = r.normal(size=(b, h, s)).astype(np.float32)
    lf = np.array(jax.nn.log_sigmoid(
        jnp.asarray(r.normal(size=(b, h, s)).astype(np.float32))))
    return q, k, v, li, lf


def _t(arrays, dtype=torch.float32):
    return [torch.from_numpy(a).to(dtype) for a in arrays]


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(x, np.float32)


SWEEP = [(2, 2, 128, 32, 32), (1, 4, 256, 64, 64), (1, 1, 64, 16, 16)]


@pytest.mark.parametrize("b,h,s,dh,ck", SWEEP)
def test_plain_matches_pallas_interpret(b, h, s, dh, ck):
    """The reference's sweep (tests/test_kernels.py:89-104)."""
    x = _inputs(b, h, s, dh)
    got = mlstm_ref(*_t(x), chunk=ck)
    want = mlstm_chunk_pallas(*map(jnp.asarray, x), chunk=ck)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("b,h,s,dh,ck", SWEEP)
def test_plain_matches_reference_oracle(b, h, s, dh, ck):
    x = _inputs(b, h, s, dh, seed=1)
    got = mlstm_ref(*_t(x))
    want = j_ref(*map(jnp.asarray, x))
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=TOL, atol=TOL)


def test_chunk_128_matches_the_model_chunk_256():
    """K3's reference chunk (128) against the model's MLSTM_CHUNK (256),
    on both sides, at S = 512 (four and two chunks)."""
    assert MLSTM_CHUNK == 256
    q, k, v, li, lf = _inputs(1, 2, 512, 32, seed=2)
    sw = lambda a: np.ascontiguousarray(np.swapaxes(a, 1, 2))  # noqa: E731
    ts = _t([sw(a) for a in (q, k, v, li, lf)])
    h128, _ = mlstm_chunkwise(*ts, chunk=128)
    h256, _ = mlstm_chunkwise(*ts, chunk=256)
    want, _ = j_chunkwise(*(jnp.asarray(sw(a)) for a in (q, k, v, li, lf)),
                          chunk=256)
    np.testing.assert_allclose(h128.numpy(), h256.numpy(), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(h256.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("s", [100, 200])
def test_ragged_length_matches_reference(s):
    """S no multiple of the chunk: the plain version falls back to one
    quadratic chunk, as the reference's; both agree with the recurrent
    oracle."""
    x = _inputs(1, 2, s, 32, seed=s)
    got = mlstm_ref(*_t(x))
    want = j_ref(*map(jnp.asarray, x))
    rec = j_rec(*map(jnp.asarray, x))
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(_f32(got), _f32(rec), rtol=TOL, atol=TOL)


def test_bfloat16_inputs_match_reference():
    """bf16 q, k, v widened to float32 inside, the output rounded to bf16
    once, on both sides; the gates stay float32."""
    q, k, v, li, lf = _inputs(1, 2, 256, 64, seed=3)
    got = mlstm_ref(*_t((q, k, v), torch.bfloat16), *_t((li, lf)))
    assert got.dtype == torch.bfloat16
    want = j_ref(*(jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v)),
                 jnp.asarray(li), jnp.asarray(lf))
    assert want.dtype == jnp.bfloat16
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=BF16_RTOL,
                               atol=TOL)


@pytest.mark.parametrize("s", [64, 96])
def test_plain_matches_recurrent_oracle(s):
    """The chunkwise form against the port's step-by-step oracle, and
    that oracle against the reference's."""
    x = _inputs(2, 2, s, 16, seed=4)
    chunked = mlstm_ref(*_t(x), chunk=32)
    rec = mlstm_recurrent_ref(*_t(x))
    np.testing.assert_allclose(chunked.numpy(), rec.numpy(), rtol=TOL,
                               atol=TOL)
    want = j_rec(*map(jnp.asarray, x))
    np.testing.assert_allclose(rec.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


def test_wrapper_value_and_grad_match_reference():
    """ops.mlstm_chunk in the model's (B,S,H,dh) layout: the value
    against the reference's mlstm_ref, the gradient of a weighted sum
    against jax.vjp of it (the reference's custom VJP).  A CPU call
    launches no kernel."""
    q, k, v, li, lf = _inputs(1, 2, 64, 16, seed=5)
    wt = np.random.default_rng(6).normal(size=q.shape).astype(np.float32)
    want, vjp = jax.vjp(j_ref, *map(jnp.asarray, (q, k, v, li, lf)))
    want_g = vjp(jnp.asarray(wt))

    sw = lambda a: np.ascontiguousarray(np.swapaxes(a, 1, 2))  # noqa: E731
    leaves = [torch.from_numpy(sw(a)).requires_grad_()
              for a in (q, k, v, li, lf)]
    before = kernel.launches
    out = ops.mlstm_chunk(*leaves)
    (out * torch.from_numpy(sw(wt))).sum().backward()
    assert kernel.launches == before
    assert out.shape == leaves[0].shape and out.dtype == torch.float32
    np.testing.assert_allclose(out.detach().numpy(), sw(np.asarray(want)),
                               rtol=TOL, atol=TOL)
    for got_g, jg in zip(leaves, want_g):
        np.testing.assert_allclose(got_g.grad.numpy(), sw(np.asarray(jg)),
                                   rtol=TOL, atol=TOL)


@pytest.mark.parametrize("bad", ["dtype", "gate_dtype", "shape",
                                 "gate_shape", "mixed", "empty"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    q, k, v = (torch.randn(1, 8, 2, 16) for _ in range(3))
    li, lf = torch.randn(1, 8, 2), torch.randn(1, 8, 2)
    if bad == "dtype":
        q, k, v = q.half(), k.half(), v.half()
    elif bad == "gate_dtype":
        li = li.double()
    elif bad == "shape":
        k = torch.randn(1, 8, 2, 8)
    elif bad == "gate_shape":
        lf = torch.randn(1, 8, 3)
    elif bad == "mixed":
        v = v.to(torch.bfloat16)
    else:
        q, k, v = (torch.randn(1, 0, 2, 16) for _ in range(3))
        li, lf = torch.randn(1, 0, 2), torch.randn(1, 0, 2)
    with pytest.raises((TypeError, ValueError)):
        ops.mlstm_chunk(q, k, v, li, lf)


def test_kernel_module_imports_without_nvcc():
    # importing and dispatching CPU tensors never builds or loads the
    # CUDA library; the build happens at the first CUDA launch
    assert kernel._lib is None
    ops.mlstm_chunk(*(torch.randn(1, 8, 2, 16) for _ in range(3)),
                    torch.randn(1, 8, 2), torch.randn(1, 8, 2))
    assert kernel._lib is None
    assert kernel.launches == 0
    assert kernel.library_path().name.startswith("libmlstm_")
    assert kernel.SOURCE.exists()
    assert "arch=compute_90a,code=sm_90a" in kernel.NVCC_FLAGS
    assert "--use_fast_math" not in kernel.NVCC_FLAGS


def test_params_struct_matches_the_cuda_source():
    """The ctypes mirror names every field of ``struct MlstmParams`` in
    the source, in order (a mismatch would shift every field after it)."""
    import re
    src = kernel.SOURCE.read_text()
    body = src[src.index("struct MlstmParams {"):]
    body = body[:body.index("};")]
    names = []
    for line in body.splitlines()[1:]:
        decl = line.split("//")[0].strip()
        m = re.fullmatch(r"(?:const\s+)?\w+\s*\*?\s+([\w\s,]+);", decl)
        if m:
            names += [n.strip() for n in m.group(1).split(",")]
    assert names == [f[0] for f in kernel.MlstmParams._fields_]
    assert f"kMaxHeadDim = {kernel.MAX_HEAD_DIM};" in src
    # the bf16 workspaces the wrapper sizes: rows a state chunk, and the
    # gate planes a (b, h)
    assert f"constexpr int kChunk = {kernel.STATE_CHUNK};" in src
    planes = src[src.index("enum { kG2 = 0"):]
    planes = planes[:planes.index("};")]
    assert planes.count(",") == kernel.GATE_PLANES


@pytest.mark.parametrize("d,want", [
    (16, 16), (20, 64), (48, 48), (64, 64),     # one 64-column box
    (100, 128), (104, 104), (128, 128),         # partly in a second box
    (136, 256), (200, 200), (256, 256),         # every box holds some of d
    (260, 512), (456, 456), (512, 512)])
def test_bf16_head_width_rule(d, want):
    """The bf16 passes take d as it is where it is a multiple of 8 (TMA's
    16-byte rule) and each 64-column box of the output pass's template
    width (64, 128, 256, 512) holds some of it; otherwise the wrapper pads
    q, k and v with zero columns to that width."""
    assert kernel.bf16_head_dim(d) == want
