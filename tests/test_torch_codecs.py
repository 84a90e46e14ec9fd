"""Port parity for the codecs: byte accounting, constructor checks and
numerics against ``repro.compress``.

A port codec takes its tensor with a leading client dimension (one row
per client, as the reference's codec under ``vmap``), so a single
reference tensor is compared as ``x[None]``.  Tolerance: none.  fp8 and
top-k do the same float32 operations on both sides (a division, a
round-to-nearest-even cast, a multiply; a selection), so they are
array-equal.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.compress import codecs as jc
from repro_torch.compress import codecs as tc

SIZES = [1, 2, 7, 128, 10_000, 524_288]


def _gen():
    return torch.Generator().manual_seed(0)


@pytest.mark.parametrize("name", tc.CODEC_NAMES)
def test_payload_bits_exact(name):
    assert tc.CODEC_NAMES == jc.CODEC_NAMES
    kws = [{}, {"omega": 32}, {"omega": 16}, {"bits": 6}, {"topk_frac": 0.2}]
    for kw in kws:
        if name in ("fp32", "identity") and "omega" not in kw:
            # the deferred-width identity codec raises on both sides
            for mod in (jc, tc):
                with pytest.raises(ValueError, match="omega"):
                    mod.get_codec(name, **kw).payload_bits(8)
            continue
        a, b = jc.get_codec(name, **kw), tc.get_codec(name, **kw)
        assert a.name == b.name
        for n in SIZES:
            assert b.payload_bits(n) == a.payload_bits(n), (name, kw, n)


@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("stochastic", [True, False])
def test_uniform_encode_decode_agree_with_apply(bits, stochastic):
    c = tc.UniformQuantCodec(bits=bits, stochastic=stochastic)
    x = torch.from_numpy(
        np.random.default_rng(bits).normal(size=(3, 16, 128))
        .astype(np.float32))
    x[1] = 0.0                                       # an all-zero client
    q, scale = c.encode(torch.Generator().manual_seed(3), x)
    assert q.dtype == torch.int8 and q.shape == x.shape
    assert scale.shape == (3,)
    assert int(q.abs().max()) <= c.qmax
    assert torch.equal(c.decode((q, scale)),
                       c.apply(torch.Generator().manual_seed(3), x))


def test_uniform_deterministic_matches_jax_codec():
    x = np.random.default_rng(4).normal(size=(5, 40)).astype(np.float32)
    for bits in (4, 8):
        want = jc.UniformQuantCodec(bits=bits, stochastic=False).apply(
            jax.random.PRNGKey(0), jnp.asarray(x))
        got = tc.UniformQuantCodec(bits=bits, stochastic=False).apply(
            None, torch.from_numpy(x)[None])[0]
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_identity_passes_bit_for_bit():
    c = tc.get_codec("fp32")
    x = torch.randn(2, 3, 5)
    assert c.apply(_gen(), x) is x
    assert c.decode(c.encode(_gen(), x)) is x
    assert tc.link_codecs("fp32").is_lossless()
    assert not tc.link_codecs("int8").is_lossless()
    assert tc.LinkCodecs().is_lossless()


@pytest.mark.parametrize("shape", [(256,), (16, 8, 8, 4), (3, 5)])
def test_fp8_matches_jax(shape):
    r = np.random.default_rng(5)
    x = (r.normal(size=shape) * 100.0).astype(np.float32)
    want = jc.Fp8Codec().apply(jax.random.PRNGKey(0), jnp.asarray(x))
    got = tc.Fp8Codec().apply(_gen(), torch.from_numpy(x)[None])[0]
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # a zero tensor takes the unit scale on both sides
    z = np.zeros(shape, np.float32)
    assert torch.equal(tc.Fp8Codec().apply(_gen(), torch.from_numpy(z)[None]),
                       torch.zeros((1,) + shape))


@pytest.mark.parametrize("frac", [0.05, 0.1, 0.5])
def test_topk_matches_jax(frac):
    x = np.random.default_rng(6).normal(size=(10, 50)).astype(np.float32)
    want = jc.TopKCodec(frac=frac).apply(jax.random.PRNGKey(0),
                                         jnp.asarray(x))
    c = tc.TopKCodec(frac=frac)
    got = c.apply(_gen(), torch.from_numpy(x)[None])[0]
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(torch.count_nonzero(got)) == c.k_for(x.size)


def test_codecs_are_per_client_rows():
    """Row u of the client dimension is client u's own tensor: its own
    scale, its own top-k."""
    x = torch.randn(2, 64)
    x[1] *= 1e-3
    for c in (tc.UniformQuantCodec(bits=8, stochastic=False), tc.Fp8Codec(),
              tc.TopKCodec(frac=0.25)):
        both = c.apply(torch.Generator().manual_seed(0), x)
        for u in range(2):
            one = c.apply(torch.Generator().manual_seed(0), x[u:u + 1])
            assert torch.equal(both[u], one[0]), c


def test_constructor_errors_match():
    for mod in (jc, tc):
        with pytest.raises(ValueError, match="2..8"):
            mod.get_codec("int8", bits=12)
        with pytest.raises(ValueError, match="2..8"):
            mod.UniformQuantCodec(bits=1)
        with pytest.raises(ValueError, match="unknown codec"):
            mod.get_codec("huffman")
        with pytest.raises(TypeError, match="must be hashable"):
            mod.TopKCodec(frac=[0.1])
        with pytest.raises(TypeError, match="must be a Codec or None"):
            mod.LinkCodecs(activations="int8")
        # frozen + hashable, equal by value
        assert mod.get_codec("int8") == mod.get_codec("int8")
        assert hash(mod.get_codec("int4")) == hash(mod.get_codec("int4"))
        c = mod.link_codecs("int4")
        assert c.activations == c.gradients == c.offload
        assert c.activations.name == "int4" and c.activations.qmax == 7
