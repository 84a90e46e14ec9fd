"""Port parity for the flash attention kernel K2 on the CPU: the port's
plain version (``ref.py``, the path a CPU tensor takes) against the JAX
reference's Pallas kernel in interpret mode and its oracle, on the same
numpy-made q, k, v; the wrapper's value and gradient against the
reference's ``ops.flash_attention`` and ``jax.grad``.

Tolerances are the reference's own (tests/test_kernels.py:34): 2e-5 in
float32 (summation order), 2e-2 in bfloat16 (both sides compute in
float32 and round the output to bfloat16 once; a float32 difference at a
rounding boundary moves one bfloat16 step).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.kernel import flash_attention_hmajor
from repro.kernels.flash_attention.ops import flash_attention as j_flash
from repro.kernels.flash_attention.ref import attention_ref as j_ref
from repro_torch.hopper import tma
from repro_torch.hopper.flash_attention import kernel, ops
from repro_torch.hopper.flash_attention.ref import attention_ref

TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _qkv(b, h, kvh, s, d, seed=0):
    r = np.random.default_rng(seed)
    return (r.normal(size=(b, h, s, d)).astype(np.float32),
            r.normal(size=(b, kvh, s, d)).astype(np.float32),
            r.normal(size=(b, kvh, s, d)).astype(np.float32))


def _t(a, dtype):
    return torch.from_numpy(a).to(getattr(torch, dtype))


def _j(a, dtype):
    return jnp.asarray(a).astype(getattr(jnp, dtype))


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("b,h,kvh,s,d", [
    (2, 4, 2, 256, 64),
    (1, 4, 4, 512, 32),
    (1, 2, 1, 128, 128),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 64), (False, 0)])
def test_plain_matches_pallas_interpret(b, h, kvh, s, d, dtype, causal,
                                        window):
    """The reference's sweep (tests/test_kernels.py:20-37)."""
    q, k, v = _qkv(b, h, kvh, s, d)
    got = attention_ref(_t(q, dtype), _t(k, dtype), _t(v, dtype),
                        causal=causal, window=window)
    assert got.dtype == getattr(torch, dtype)
    want = flash_attention_hmajor(_j(q, dtype), _j(k, dtype), _j(v, dtype),
                                  causal=causal, window=window, block_q=128,
                                  block_k=128)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=TOL[dtype],
                               atol=TOL[dtype])


@pytest.mark.parametrize("case", ["softcap", "ragged", "ragged_window",
                                  "noncausal_window", "bank_seq"])
def test_plain_matches_reference_oracle(case):
    """Softcap 20, a ragged S (100, no multiple of any tile), a window
    without causality, and S = 32 (the head bank at the reference's
    size), against the reference's oracle in float32."""
    shape, kw = {
        "softcap": ((1, 2, 2, 256, 32), dict(causal=True, softcap=20.0)),
        "ragged": ((2, 4, 2, 100, 64), dict(causal=True)),
        "ragged_window": ((1, 4, 1, 100, 32), dict(causal=True, window=7)),
        "noncausal_window": ((1, 2, 1, 96, 16),
                             dict(causal=False, window=20)),
        "bank_seq": ((6, 4, 4, 32, 64), dict(causal=True, window=64)),
    }[case]
    q, k, v = _qkv(*shape, seed=3)
    got = attention_ref(_t(q, "float32"), _t(k, "float32"),
                        _t(v, "float32"), **kw)
    want = j_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=2e-5, atol=2e-5)


def test_plain_matches_pallas_softcap():
    """The reference's softcap test (tests/test_kernels.py:40-48)."""
    q, k, v = _qkv(1, 2, 2, 256, 32, seed=1)
    got = attention_ref(_t(q, "float32"), _t(k, "float32"),
                        _t(v, "float32"), causal=True, softcap=20.0)
    want = flash_attention_hmajor(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), causal=True, softcap=20.0,
                                  block_q=64, block_k=64)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("causal,window,softcap", [(True, 0, 0.0),
                                                   (True, 16, 0.0),
                                                   (False, 0, 20.0)])
def test_wrapper_value_and_grad_match_reference(causal, window, softcap):
    """ops.flash_attention in the model's (B,S,H,d) layout: the value
    against the reference wrapper, the gradient of a weighted sum against
    jax.grad through the reference's custom VJP (both recompute through
    their dense path).  A CPU call launches no kernel."""
    r = np.random.default_rng(5)
    q = r.normal(size=(2, 64, 4, 32)).astype(np.float32)
    k = r.normal(size=(2, 64, 2, 32)).astype(np.float32)
    v = r.normal(size=(2, 64, 2, 32)).astype(np.float32)
    wt = r.normal(size=q.shape).astype(np.float32)

    def j_obj(q_, k_, v_):
        return (j_flash(q_, k_, v_, causal, window, softcap) * wt).sum()

    want = j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal,
                   window, softcap)
    want_g = jax.grad(j_obj, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))

    before = kernel.launches
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = ops.flash_attention(tq, tk, tv, causal, window, softcap)
    (out * torch.from_numpy(wt)).sum().backward()
    assert kernel.launches == before
    assert out.shape == tq.shape and out.dtype == torch.float32
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               rtol=2e-5, atol=2e-5)
    for got_g, jg in zip((tq.grad, tk.grad, tv.grad), want_g):
        np.testing.assert_allclose(got_g.numpy(), np.asarray(jg), rtol=1e-4,
                                   atol=1e-4)


def test_wrapper_bfloat16_matches_reference():
    r = np.random.default_rng(6)
    q = r.normal(size=(1, 96, 4, 64)).astype(np.float32)
    k = r.normal(size=(1, 96, 2, 64)).astype(np.float32)
    v = r.normal(size=(1, 96, 2, 64)).astype(np.float32)
    got = ops.flash_attention(*(_t(a, "bfloat16") for a in (q, k, v)),
                              True, 32, 0.0)
    assert got.dtype == torch.bfloat16
    want = j_flash(*(_j(a, "bfloat16") for a in (q, k, v)), True, 32, 0.0)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("bad", ["dtype", "head_dim", "bf16_head_dim",
                                 "kv_heads", "seq", "window", "mixed"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    q, k, v = (torch.randn(1, 8, 4, 32), torch.randn(1, 8, 2, 32),
               torch.randn(1, 8, 2, 32))
    kw = {}
    if bad == "dtype":
        q, k, v = q.half(), k.half(), v.half()
    elif bad == "head_dim":
        q, k, v = (torch.randn(1, 8, 2, 272), torch.randn(1, 8, 2, 272),
                   torch.randn(1, 8, 2, 272))
    elif bad == "bf16_head_dim":
        q, k, v = (torch.randn(1, 8, 2, 40, dtype=torch.bfloat16)
                   for _ in range(3))
    elif bad == "kv_heads":
        k, v = torch.randn(1, 8, 3, 32), torch.randn(1, 8, 3, 32)
    elif bad == "seq":
        k, v = torch.randn(1, 9, 2, 32), torch.randn(1, 9, 2, 32)
    elif bad == "window":
        kw = {"window": -1}
    else:
        k = k.to(torch.bfloat16)
    with pytest.raises((TypeError, ValueError)):
        ops.flash_attention(q, k, v, **kw)


def test_kernel_module_imports_without_nvcc():
    # importing and dispatching CPU tensors never builds or loads the
    # CUDA library; the build happens at the first CUDA launch
    assert kernel._lib is None
    ops.flash_attention(torch.randn(1, 8, 2, 16), torch.randn(1, 8, 1, 16),
                        torch.randn(1, 8, 1, 16))
    assert kernel._lib is None
    assert kernel.launches == 0
    assert kernel.library_path().name.startswith("libflash_")
    assert kernel.SOURCE.exists()
    assert "arch=compute_90a,code=sm_90a" in kernel.NVCC_FLAGS
    assert "--use_fast_math" not in kernel.NVCC_FLAGS


def test_params_struct_matches_the_cuda_source():
    """The ctypes mirror names every field of ``struct FlashParams`` in
    the source, in order (a mismatch would shift every field after it)."""
    import re
    src = kernel.SOURCE.read_text()
    body = src[src.index("struct FlashParams {"):]
    body = body[:body.index("};")]
    names = []
    for line in body.splitlines()[1:]:
        decl = line.split("//")[0].strip()
        m = re.fullmatch(r"(?:const\s+)?\w+\s*\*?\s+([\w\s,]+);", decl)
        if m:
            names += [n.strip() for n in m.group(1).split(",")]
    assert names == [f[0] for f in kernel.FlashParams._fields_]


@pytest.mark.parametrize("case,ok", [
    ("contiguous", True),
    ("fused_slice", True),      # q, k, v of one fused projection
    ("one_batch_any_stride", True),
    ("head_major_transpose", False),
    ("unaligned_stride", False),
    ("overlapping_heads", False),
])
def test_tma_layout_rule(case, ok):
    """Which bf16 layouts the kernel's TMA tensor maps read in place;
    ``kernel_layout`` copies the others to contiguous ones."""
    if case == "contiguous":
        t = torch.zeros(2, 33, 4, 64, dtype=torch.bfloat16)
    elif case == "fused_slice":
        t = torch.zeros(2, 33, 8, 64, dtype=torch.bfloat16)[:, :, 4:6]
    elif case == "one_batch_any_stride":
        t = torch.zeros(1, 33, 4, 64, dtype=torch.bfloat16).as_strided(
            (1, 33, 4, 64), (8, 256, 64, 1))
    elif case == "head_major_transpose":
        t = torch.zeros(2, 4, 33, 64, dtype=torch.bfloat16).transpose(1, 2)
    elif case == "unaligned_stride":
        t = torch.zeros(2, 33, 4, 68, dtype=torch.bfloat16)[..., :64]
    else:
        t = torch.zeros(2, 33, 64, dtype=torch.bfloat16).unsqueeze(2) \
            .expand(2, 33, 4, 64)
    assert tma.tma_layout_ok(t.shape, t.stride()) is ok
    laid = tma.kernel_layout(t)
    assert tma.tma_layout_ok(laid.shape, laid.stride())
    assert (laid is t) is ok
