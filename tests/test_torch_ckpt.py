"""Port parity for ``repro_torch.checkpoint`` against the reference's
``repro.checkpoint``: the reference's own cases (``tests/
test_checkpoint.py``) on the port, files crossing in both directions
(float32, bit for bit), and bfloat16 leaves (R3 in ROADMAP.md: the
reference writes them as raw 16 bits, dtype ``|V2``, and cannot read
them back; the port reads either package's ``|V2`` leaves bit for bit
and resumes its own bf16 state)."""

import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint import load_checkpoint as j_load
from repro.checkpoint import save_checkpoint as j_save
from repro.configs.registry import get_arch as j_get_arch
from repro.models import build_model as j_build
from repro_torch.checkpoint import (latest_step, load_checkpoint,
                                    restore_rng_state, rng_state_array,
                                    save_checkpoint)
from repro_torch.configs.registry import get_arch
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.models.registry import build_model
from repro_torch.utils.prng import make_generator
from repro_torch.utils.tree import path_leaves, tree_map


def _params(dtype=None):
    cfg = get_arch("xlstm-350m").reduced()
    return build_model(cfg).init(make_generator(0), dtype=dtype)


def _bits_equal(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    if a.dtype == torch.bfloat16:
        a, b = a.view(torch.int16), b.view(torch.int16)
    return torch.equal(a, b)


def _state(params):
    """The training state tree of launch/train.py."""
    return {"params": params, "opt_state": {"count": torch.tensor(
                [3, 3], dtype=torch.int32)},
            "round": np.int64(4), "sim_time_s": np.float64(1.5)}


def test_roundtrip(tmp_path):
    params = _params()
    d = str(tmp_path / "ckpt")
    save_checkpoint(d, 3, params)
    save_checkpoint(d, 7, params)
    assert latest_step(d) == 7
    restored = load_checkpoint(d, 7, tree_map(torch.zeros_like, params))
    for (p, a), (q, b) in zip(path_leaves(params), path_leaves(restored)):
        assert p == q and torch.equal(a, b), p


def test_shape_mismatch_raises(tmp_path):
    d = str(tmp_path / "c")
    save_checkpoint(d, 0, {"w": torch.ones(3, 3)})
    with pytest.raises(ValueError):
        load_checkpoint(d, 0, {"w": torch.ones(2, 2)})
    with pytest.raises(KeyError):
        load_checkpoint(d, 0, {"w2": torch.ones(3, 3)})


def test_dtype_mismatch_raises_unless_cast(tmp_path):
    d = str(tmp_path / "c")
    save_checkpoint(d, 0, {"w": torch.full((2,), 1.5)})
    with pytest.raises(ValueError, match="cast=True"):
        load_checkpoint(d, 0, {"w": torch.zeros(2, dtype=torch.int8)})
    out = load_checkpoint(d, 0, {"w": np.zeros((2,), np.float64)},
                          cast=True)
    assert out["w"].dtype == np.float64
    np.testing.assert_array_equal(out["w"], [1.5, 1.5])
    out = load_checkpoint(d, 0, {"w": torch.zeros(2, dtype=torch.float64)},
                          cast=True)
    assert out["w"].dtype == torch.float64 and out["w"].tolist() == [1.5,
                                                                     1.5]


def test_crash_mid_save_leaves_no_torn_checkpoint(tmp_path):
    d = str(tmp_path / "c")
    save_checkpoint(d, 1, {"w": torch.ones(2)})
    torn = os.path.join(d, "ckpt_00000002.npz.tmp.npz")
    np.savez(torn, w=np.zeros((2,)))
    assert latest_step(d) == 1
    restored = load_checkpoint(d, 1, {"w": torch.zeros(2)})
    assert restored["w"].tolist() == [1.0, 1.0]
    save_checkpoint(d, 2, {"w": torch.full((2,), 2.0)})
    assert not os.path.exists(torn)
    assert latest_step(d) == 2
    assert latest_step(str(tmp_path / "missing")) is None


def test_rng_state_round_trip():
    rng = np.random.default_rng(7)
    rng.standard_normal(13)
    rng.integers(0, 10)
    arr = rng_state_array(rng)
    assert arr.shape == (6,) and arr.dtype == np.uint64
    want = rng.standard_normal(8)
    other = np.random.default_rng(0)
    restore_rng_state(other, arr)
    np.testing.assert_array_equal(other.standard_normal(8), want)
    with pytest.raises(ValueError):
        restore_rng_state(other, np.zeros(4, np.uint64))
    with pytest.raises(TypeError):
        rng_state_array(np.random.Generator(np.random.MT19937(0)))


def test_state_tree_round_trip_keeps_numpy_leaves(tmp_path):
    st = _state(_params())
    d = str(tmp_path / "s")
    save_checkpoint(d, 4, st)
    with np.load(os.path.join(d, "ckpt_00000004.npz")) as f:
        assert "opt_state/count" in f.files and "round" in f.files
        assert "params/stage0/b0/block/q/w" in f.files
    back = load_checkpoint(d, 4, _state(tree_map(torch.zeros_like,
                                                 st["params"])))
    assert int(back["round"]) == 4 and float(back["sim_time_s"]) == 1.5
    assert back["opt_state"]["count"].dtype == torch.int32
    for (_, a), (_, b) in zip(path_leaves(st), path_leaves(back)):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b)


# -------------------------------------------------- across the packages ----
def test_reference_file_reads_in_port_bit_for_bit(tmp_path):
    jp = j_build(j_get_arch("xlstm-350m").reduced()).init(
        jax.random.PRNGKey(1))
    d = str(tmp_path / "r")
    j_save(d, 5, {"params": jp, "round": np.int64(5)})
    target = {"params": params_from_numpy(jax.tree.map(
        lambda x: np.zeros(x.shape, x.dtype), jp), "cpu"),
              "round": np.int64(0)}
    got = load_checkpoint(d, 5, target)
    want = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    for (p, a), (_, b) in zip(path_leaves(got["params"]),
                              path_leaves(want)):
        assert _bits_equal(a, b), p
    assert int(got["round"]) == 5


def test_port_file_reads_in_reference_bit_for_bit(tmp_path):
    params = _params()
    d = str(tmp_path / "p")
    save_checkpoint(d, 2, {"params": params, "round": np.int64(2)})
    np_params = params_to_numpy(params)
    target = {"params": jax.tree.map(jnp.zeros_like, jax.tree.map(
        jnp.asarray, np_params)), "round": np.int64(0)}
    got = j_load(d, 2, target)
    flat = dict(path_leaves(np_params))
    for p, a in path_leaves({k: v for k, v in got["params"].items()}):
        np.testing.assert_array_equal(np.asarray(a), flat[p], err_msg=p)


def _bf16_tree():
    rng = np.random.default_rng(2)
    return {"w": rng.standard_normal((4, 6)).astype(ml_dtypes.bfloat16),
            "b": rng.standard_normal(6).astype(np.float32)}


def test_reference_bf16_leaf_reads_in_port_bit_for_bit(tmp_path):
    """R3: the reference writes a bf16 leaf as ``|V2`` and cannot read it
    back (neither as bfloat16 nor with cast=True); the port reads the raw
    bits into a bfloat16 target."""
    tree = _bf16_tree()
    d = str(tmp_path / "b")
    j_save(d, 1, jax.tree.map(jnp.asarray, tree))
    with np.load(os.path.join(d, "ckpt_00000001.npz")) as f:
        assert f["w"].dtype == np.dtype("V2")
    jt = jax.tree.map(jnp.zeros_like, jax.tree.map(jnp.asarray, tree))
    for cast in (False, True):
        with pytest.raises((ValueError, TypeError)):
            j_load(d, 1, jt, cast=cast)
    target = {"w": torch.zeros(4, 6, dtype=torch.bfloat16),
              "b": torch.zeros(6)}
    got = load_checkpoint(d, 1, target)
    want = params_from_numpy(tree, "cpu")
    assert _bits_equal(got["w"], want["w"]) and torch.equal(got["b"],
                                                            want["b"])
    with pytest.raises(ValueError, match="cast=True"):
        load_checkpoint(d, 1, {"w": torch.zeros(4, 6), "b": torch.zeros(6)})
    cast = load_checkpoint(d, 1, {"w": torch.zeros(4, 6),
                                  "b": torch.zeros(6)}, cast=True)
    assert torch.equal(cast["w"], want["w"].float())


def test_port_bf16_state_round_trips_bit_for_bit(tmp_path):
    """A full-width-style bf16 training state (params, optimizer count,
    cursor) written and read back by the port: every leaf bit-equal, and
    the file's bf16 leaves in the reference's ``|V2`` layout."""
    st = _state(_params(dtype=torch.bfloat16))
    d = str(tmp_path / "s")
    save_checkpoint(d, 4, st)
    with np.load(os.path.join(d, "ckpt_00000004.npz")) as f:
        assert f["params/lm_head/w"].dtype == np.dtype("V2")
    zero = _state(tree_map(torch.zeros_like, st["params"]))
    back = load_checkpoint(d, 4, zero)
    for (p, a), (_, b) in zip(path_leaves(st), path_leaves(back)):
        if isinstance(a, torch.Tensor):
            assert _bits_equal(a, b), p
