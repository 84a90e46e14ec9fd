"""Port parity for the LM building blocks: configs, the bfloat16
conversion, parameter-creation helpers, norms, activations, softcap,
RoPE, the gated MLP and the synthetic token stream, against the JAX
package on the same numpy inputs.

Tolerances: 1e-6 for float32 elementwise math (one or two roundings of
transcendental functions that differ by an ulp between XLA and PyTorch);
1e-5 for the MLP's matmuls (summation order); one bfloat16 step (2^-7
relative) where the result is rounded to bfloat16 once.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_arch as j_get_arch
from repro.data.synthetic import synthetic_token_batch as j_tokens
from repro.models import layers as jl
from repro_torch.configs import base as cbase
from repro_torch.configs.registry import NOT_PORTED, get_arch
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.data.synthetic import synthetic_token_batch
from repro_torch.models import init_utils, layers


def _x(shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape)
            * scale).astype(np.float32)


# ---------------------------------------------------------------- configs --
@pytest.mark.parametrize("kw", [{}, {"num_layers": 12}])
def test_gemma3_config_and_reduced_match_reference(kw):
    ours, ref = get_arch("gemma3-12b"), j_get_arch("gemma3-12b")
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert (dataclasses.asdict(ours.reduced(**kw))
            == dataclasses.asdict(ref.reduced(**kw)))
    assert ours.layer_kinds() == ref.layer_kinds()
    assert ours.padded_vocab == ref.padded_vocab


@pytest.mark.parametrize("kw", [{}, {"num_layers": 6}])
def test_xlstm_config_and_reduced_match_reference(kw):
    ours, ref = get_arch("xlstm-350m"), j_get_arch("xlstm-350m")
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert (dataclasses.asdict(ours.reduced(**kw))
            == dataclasses.asdict(ref.reduced(**kw)))
    assert ours.layer_kinds() == ref.layer_kinds()
    assert ours.padded_vocab == ref.padded_vocab


@pytest.mark.parametrize("kw", [{}, {"num_layers": 8}])
def test_recurrentgemma_config_and_reduced_match_reference(kw):
    ours, ref = get_arch("recurrentgemma-2b"), j_get_arch("recurrentgemma-2b")
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert (dataclasses.asdict(ours.reduced(**kw))
            == dataclasses.asdict(ref.reduced(**kw)))
    assert ours.layer_kinds() == ref.layer_kinds()
    assert ours.padded_vocab == ref.padded_vocab
    assert ours.reduced(**kw).rglru.lru_width == ours.reduced(**kw).d_model


def test_every_reference_arch_is_ported_or_named():
    from repro.configs.registry import ARCHS
    from repro_torch.configs.registry import ARCHS as PORTED
    assert set(PORTED) <= set(ARCHS)
    for name in ARCHS:
        if name in PORTED:
            continue
        assert name in NOT_PORTED
        with pytest.raises(KeyError, match="not ported yet"):
            get_arch(name)
    with pytest.raises(KeyError, match="unknown arch"):
        get_arch("no-such-model")
    # the sub-config dataclasses are whole copies
    from repro.configs import base as jbase
    for cls in ("MoEConfig", "MLAConfig", "EncDecConfig", "VLMConfig",
                "XLSTMConfig", "RGLRUConfig", "ModelConfig"):
        assert ([f.name for f in dataclasses.fields(getattr(cbase, cls))]
                == [f.name for f in dataclasses.fields(getattr(jbase, cls))])
    assert cbase.BLOCK_KINDS == jbase.BLOCK_KINDS


# --------------------------------------------------------------- convert ---
def test_convert_carries_bfloat16_bit_identically():
    a = np.asarray(jnp.asarray(_x((5, 7), 1, 3.0), jnp.bfloat16))
    f = _x((3,), 2)
    t = params_from_numpy({"w": {"a": a}, "f": f}, "cpu")
    assert t["w"]["a"].dtype == torch.bfloat16
    assert t["f"].dtype == torch.float32
    # the same values, not only the same bits
    np.testing.assert_array_equal(t["w"]["a"].to(torch.float32).numpy(),
                                  a.astype(np.float32))
    back = params_to_numpy(t)
    assert back["w"]["a"].dtype == a.dtype
    np.testing.assert_array_equal(back["w"]["a"].view(np.uint16),
                                  a.view(np.uint16))
    np.testing.assert_array_equal(back["f"], f)
    # and the JAX side takes the round trip back
    assert jnp.asarray(back["w"]["a"]).dtype == jnp.bfloat16


# ---------------------------------------------------------- init helpers ---
def test_init_helpers_shapes_dtypes_and_scale():
    gen = torch.Generator().manual_seed(0)
    d = init_utils.dense(gen, 64, (4, 16), bias=True, dtype=torch.bfloat16)
    assert d["w"].shape == (64, 4, 16) and d["w"].dtype == torch.bfloat16
    assert d["b"].shape == (4, 16) and not d["b"].any()
    w = init_utils.dense(gen, 400, 300)["w"]
    assert w.abs().max() <= 2.0 / 20.0 + 1e-7       # truncated at 2 sigma
    assert abs(float(w.std()) - 0.88 / 20.0) < 0.004  # trunc-normal std
    n = init_utils.norm(8, "layernorm", torch.bfloat16)
    assert n["scale"].dtype == torch.bfloat16 and n["bias"].shape == (8,)
    e = init_utils.embedding(gen, 50, 8)
    assert e["table"].shape == (50, 8)
    with pytest.raises(ValueError):
        init_utils.norm(8, "batchnorm")


# ------------------------------------------------------------ layer math ---
@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_norm(kind, dtype):
    x = _x((3, 5, 32), 3, 2.0)
    p = {"scale": _x((32,), 4), "bias": _x((32,), 5)}
    if kind == "rmsnorm":
        p.pop("bias")
    jx = jnp.asarray(x).astype(dtype)
    want = jl.apply_norm(jax.tree.map(jnp.asarray, p), jx, kind)
    got = layers.apply_norm(params_from_numpy(p, "cpu"),
                            torch.from_numpy(x).to(getattr(torch, dtype)),
                            kind)
    assert got.dtype == getattr(torch, dtype)
    tol = 1e-6 if dtype == "float32" else 2 ** -7
    np.testing.assert_allclose(got.to(torch.float32).numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("name", ["gelu", "silu"])
def test_activation_is_the_reference_form(name):
    x = np.linspace(-6, 6, 241).astype(np.float32)
    got = layers.activation(name)(torch.from_numpy(x)).numpy()
    want = np.asarray(jl.activation(name)(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    if name == "gelu":       # the tanh form, not the exact erf one
        exact = torch.nn.functional.gelu(torch.tensor(1.0)).item()
        assert abs(got[140] - exact) > 1e-5       # x = 1.0


def test_softcap():
    x = _x((4, 9), 6, 40.0)
    for cap in (0.0, 20.0):
        np.testing.assert_allclose(
            layers.softcap(torch.from_numpy(x), cap).numpy(),
            np.asarray(jl.softcap(jnp.asarray(x), cap)), rtol=1e-6,
            atol=1e-5)


@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rope(theta, dtype):
    np.testing.assert_allclose(layers.rope_freqs(64, theta).numpy(),
                               np.asarray(jl.rope_freqs(64, theta)),
                               rtol=1e-6)
    x = _x((2, 40, 3, 64), 7)
    pos = np.broadcast_to(np.arange(40)[None] + 1000, (2, 40)).astype(
        np.int32)
    want = jl.apply_rope(jnp.asarray(x).astype(dtype), jnp.asarray(pos),
                         theta)
    got = layers.apply_rope(torch.from_numpy(x).to(getattr(torch, dtype)),
                            torch.from_numpy(pos.copy()), theta)
    tol = 2e-5 if dtype == "float32" else 2 ** -7
    np.testing.assert_allclose(got.to(torch.float32).numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("act", ["gelu", "silu"])
def test_mlp(act):
    cfg = get_arch("gemma3-12b").reduced()
    p = {k: {"w": _x(s, i, 0.1)} for i, (k, s) in enumerate(
        [("gate", (256, 512)), ("up", (256, 512)), ("down", (512, 256))])}
    x = _x((2, 6, 256), 9)
    want = jl.mlp_apply(jax.tree.map(jnp.asarray, p), jnp.asarray(x), act)
    got = layers.mlp_apply(params_from_numpy(p, "cpu"), torch.from_numpy(x),
                           act)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    gen = torch.Generator().manual_seed(0)
    shapes = {k: tuple(v["w"].shape)
              for k, v in layers.mlp_init(gen, cfg).items()}
    assert shapes == {k: v["w"].shape for k, v in p.items()}


@pytest.mark.parametrize("seed", [0, 2])
def test_synthetic_token_batch_is_the_reference_stream(seed):
    ours = synthetic_token_batch(seed, 2, 32, 512)
    ref = j_tokens(seed, 2, 32, 512)
    for k in ("tokens", "labels"):
        assert ours[k].dtype == ref[k].dtype
        np.testing.assert_array_equal(ours[k], ref[k])
