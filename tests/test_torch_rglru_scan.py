"""Port parity for the RG-LRU scan kernel K4 on the CPU: the port's plain
versions (``ref.py``; the sequential one is the path a CPU tensor takes)
against the JAX reference's Pallas kernel in interpret mode and its
oracles, on the same numpy-made inputs; the wrapper's value and gradient
against ``jax.vjp`` of the reference's ``rglru_scan``.

Tolerances: the reference's own, 1e-4 in float32 and 5e-2 for bfloat16
inputs and output (tests/test_kernels.py:75) for the sequential form, and
1e-4 / 1e-5 (rtol / atol) for the parallel form (tests/test_recurrent.py:
66, 80): exp rounds an ulp apart between XLA and PyTorch, and the
parallel forms sum in different trees.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rglru_scan.kernel import rglru_scan_pallas
from repro.kernels.rglru_scan.ops import rglru_scan as j_rglru_scan
from repro.kernels.rglru_scan.ref import rglru_scan_ref as j_ref
from repro.models.rglru import rglru_scan_assoc as j_assoc
from repro_torch.hopper.rglru_scan import kernel, ops
from repro_torch.hopper.rglru_scan.ref import rglru_scan_assoc, rglru_scan_ref

TOL = {"float32": 1e-4, "bfloat16": 5e-2}


def _inputs(b, s, w, seed=0, scale=0.1):
    """log_a <= 0, b and h0, drawn as the reference's sweep draws them
    (tests/test_kernels.py:70-72)."""
    r = np.random.default_rng(seed)
    la = (-np.abs(r.normal(size=(b, s, w))) * scale).astype(np.float32)
    bb = r.normal(size=(b, s, w)).astype(np.float32)
    h0 = r.normal(size=(b, w)).astype(np.float32)
    return la, bb, h0


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("b,s,w,bt,bw", [
    (2, 128, 64, 32, 64),
    (1, 256, 512, 64, 256),
    (3, 64, 128, 64, 128),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_pallas_interpret_and_oracle(b, s, w, bt, bw, dtype):
    """The reference's sweep (tests/test_kernels.py:63-77): the inputs
    rounded to ``dtype`` on both sides, h0 float32, the output in
    log_a's dtype."""
    la, bb, h0 = _inputs(b, s, w)
    jla, jbb = (jnp.asarray(a).astype(dtype) for a in (la, bb))
    want = rglru_scan_pallas(jla, jbb, jnp.asarray(h0), block_t=bt,
                             block_w=bw)
    oracle = j_ref(jla, jbb, jnp.asarray(h0))
    tdt = getattr(torch, dtype)
    got = rglru_scan_ref(torch.from_numpy(la).to(tdt),
                         torch.from_numpy(bb).to(tdt), torch.from_numpy(h0))
    assert got.dtype == tdt and got.shape == (b, s, w)
    tol = TOL[dtype]
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol, atol=tol)
    np.testing.assert_allclose(_f32(got), _f32(oracle), rtol=tol, atol=tol)


def test_plain_takes_mixed_dtypes_as_the_pallas_kernel():
    """bfloat16 log_a with float32 b: both widen to float32 and the output
    takes log_a's dtype."""
    la, bb, h0 = _inputs(2, 64, 32, seed=1)
    jla = jnp.asarray(la).astype(jnp.bfloat16)
    want = rglru_scan_pallas(jla, jnp.asarray(bb), jnp.asarray(h0))
    got = rglru_scan_ref(torch.from_numpy(la).to(torch.bfloat16),
                         torch.from_numpy(bb), torch.from_numpy(h0))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=5e-2, atol=5e-2)


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("b,s,w,scale", [(2, 48, 16, 0.2), (1, 8, 4, 1.0),
                                         (2, 100, 24, 0.2), (2, 1, 8, 0.2)])
def test_assoc_matches_reference_assoc_and_sequential(b, s, w, scale,
                                                      with_h0):
    """The model's parallel form against the reference's
    ``rglru_scan_assoc`` (tests/test_recurrent.py:54-80: S 48 and 8; and
    100, not a power of two, and a single step), and against the
    sequential form."""
    la, bb, h0 = _inputs(b, s, w, seed=s, scale=scale)
    th0 = torch.from_numpy(h0) if with_h0 else None
    got = rglru_scan_assoc(torch.from_numpy(la), torch.from_numpy(bb), th0)
    want = j_assoc(jnp.asarray(la), jnp.asarray(bb),
                   jnp.asarray(h0) if with_h0 else None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)
    seq = rglru_scan_ref(torch.from_numpy(la), torch.from_numpy(bb),
                         th0 if with_h0 else torch.zeros(b, w))
    np.testing.assert_allclose(got.numpy(), seq.numpy(), rtol=1e-4,
                               atol=1e-5)


def test_wrapper_value_and_grad_match_reference():
    """ops.rglru_scan: the value against the reference's ``rglru_scan``
    (the Pallas kernel in interpret mode), the gradient of a weighted sum
    against ``jax.vjp`` of it (its custom VJP through the sequential
    oracle), for log_a, b and h0.  A CPU call launches no kernel."""
    la, bb, h0 = _inputs(2, 32, 16, seed=3, scale=0.5)
    wt = np.random.default_rng(4).normal(size=la.shape).astype(np.float32)
    want, vjp = jax.vjp(j_rglru_scan, *map(jnp.asarray, (la, bb, h0)))
    want_g = vjp(jnp.asarray(wt))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (la, bb, h0)]
    before = kernel.launches
    out = ops.rglru_scan(*leaves)
    (out * torch.from_numpy(wt)).sum().backward()
    assert kernel.launches == before
    assert out.shape == la.shape and out.dtype == torch.float32
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-4)
    for got_g, jg in zip(leaves, want_g):
        np.testing.assert_allclose(got_g.grad.numpy(), np.asarray(jg),
                                   rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("bad", ["dtype", "b_dtype", "h0_dtype", "shape",
                                 "h0_shape", "rank", "mixed_device",
                                 "empty"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    la, bb, h0 = (torch.from_numpy(a) for a in _inputs(1, 8, 4))
    if bad == "dtype":
        la = la.half()
    elif bad == "b_dtype":
        bb = bb.double()
    elif bad == "h0_dtype":
        h0 = h0.to(torch.bfloat16)
    elif bad == "shape":
        bb = torch.randn(1, 8, 5)
    elif bad == "h0_shape":
        h0 = torch.randn(2, 4)
    elif bad == "rank":
        la, bb = la[0], bb[0]
    elif bad == "mixed_device":
        h0 = h0.to("meta")
    else:
        la, bb = torch.zeros(1, 0, 4), torch.zeros(1, 0, 4)
    with pytest.raises((TypeError, ValueError)):
        ops.rglru_scan(la, bb, h0)


def test_kernel_module_imports_without_nvcc():
    # importing and dispatching CPU tensors never builds or loads the
    # CUDA library; the build happens at the first CUDA launch
    assert kernel._lib is None
    ops.rglru_scan(torch.zeros(1, 8, 4), torch.randn(1, 8, 4),
                   torch.zeros(1, 4))
    assert kernel._lib is None
    assert kernel.launches == 0
    assert kernel.library_path().name.startswith("librglru_")
    assert kernel.SOURCE.exists()
    assert "arch=compute_90a,code=sm_90a" in kernel.NVCC_FLAGS
    assert "--use_fast_math" not in kernel.NVCC_FLAGS


def test_params_struct_matches_the_cuda_source():
    """The ctypes mirror names every field of ``struct RglruParams`` in the
    source, in order (a mismatch would shift every field after it), and
    the C entry point takes the dtype codes the wrapper passes."""
    import re
    src = kernel.SOURCE.read_text()
    body = src[src.index("struct RglruParams {"):]
    body = body[:body.index("};")]
    names = []
    for line in body.splitlines()[1:]:
        decl = line.split("//")[0].strip()
        m = re.fullmatch(r"(?:const\s+)?\w+\s*\*?\s+([\w\s,]+);", decl)
        if m:
            names += [n.strip() for n in m.group(1).split(",")]
    assert names == [f[0] for f in kernel.RglruParams._fields_]
    assert "0 float32, 1 bfloat16" in src
    assert kernel.DTYPES == {torch.float32: 0, torch.bfloat16: 1}
    assert "expf(" in src and "__expf(" not in src
