"""Port parity for the small modules: seed streams, trees, the host half of
the hierarchy, RNG state arrays and FedSim's aggregation weights.

Tolerance: none, except the aggregated trees (float32 weighted sums, the
same products and the same order on both sides, checked to rtol 1e-6 in
case an accumulation order differs).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.checkpoint import ckpt as jckpt
from repro.configs.base import HierarchyConfig as JH, TrainConfig as JT
from repro.configs.phsfl_cnn import CNNConfig as JCNNConfig
from repro.core import hierarchy as jh
from repro.core.fedsim import FedSim as JFedSim
from repro.data.synthetic import make_federated_image_data as j_data
from repro_torch.checkpoint import rng as trng
from repro_torch.configs import CNNConfig, HierarchyConfig, TrainConfig
from repro_torch.core import hierarchy as th
from repro_torch.core.fedsim import FedSim
from repro_torch.data.synthetic import make_federated_image_data
from repro_torch.utils import prng, tree


def test_string_hash_is_the_references():
    # repro.utils.prng.fold_in_str's datum, written out
    def ref_hash(name):
        h = 0
        for ch in name:
            h = (h * 131 + ord(ch)) % (2**31 - 1)
        return h
    for name in ("", "['conv1']['w']", "['conv1']['b']", "x" * 300):
        assert prng.str_hash(name) == ref_hash(name)


def test_seed_streams_are_deterministic_and_distinct():
    a = prng.fold_in_str(7, "['conv1']['w']")
    assert a == prng.fold_in_str(7, "['conv1']['w']")
    seeds = {prng.fold_in_str(7, "['conv1']['w']"),
             prng.fold_in_str(7, "['conv1']['b']"),
             prng.fold_in_str(8, "['conv1']['w']"), prng.fold_in(7, 0)}
    assert len(seeds) == 4
    assert all(0 <= s < 2 ** prng.SEED_BITS for s in seeds)
    g1, g2 = prng.make_generator(a), prng.make_generator(a)
    assert torch.equal(torch.rand(8, generator=g1), torch.rand(8, generator=g2))
    chain1, chain2 = prng.make_generator(3), prng.make_generator(3)
    d1 = [prng.draw_seed(chain1) for _ in range(4)]
    assert d1 == [prng.draw_seed(chain2) for _ in range(4)]
    assert len(set(d1)) == 4


def test_leaf_paths_read_like_jax_keystr():
    t = {"conv1": {"w": torch.zeros(1), "b": torch.zeros(1)},
         "fc2": {"w": torch.zeros(1)}}
    jt = jax.tree.map(lambda x: jnp.zeros(1), {"conv1": {"w": 0, "b": 0},
                                              "fc2": {"w": 0}})
    want = sorted(jax.tree_util.keystr(p)
                  for p, _ in jax.tree_util.tree_flatten_with_path(jt)[0])
    assert sorted(p for p, _ in tree.tree_leaves_with_path(t)) == want
    assert len(tree.tree_leaves(t)) == 3


def test_tuple_caches_map_and_read_like_jax_keystr():
    """The recurrent caches hold tuples (the mLSTM carry (C, n, m)):
    ``tree_map`` keeps them tuples and walks several trees in step, and
    their leaf paths read as jax's ``['carry'][0]``."""
    t = {"conv": torch.zeros(2), "carry": (torch.ones(2), torch.ones(3),
                                           torch.full((1,), 2.0))}
    jt = {"conv": jnp.zeros(2), "carry": (jnp.ones(2), jnp.ones(3),
                                          jnp.full((1,), 2.0))}
    want = sorted(jax.tree_util.keystr(p)
                  for p, _ in jax.tree_util.tree_flatten_with_path(jt)[0])
    assert sorted(p for p, _ in tree.tree_leaves_with_path(t)) == want
    stacked = tree.tree_map(lambda a: a.expand(3, *a.shape).clone(), t)
    assert isinstance(stacked["carry"], tuple)
    assert tuple(stacked["carry"][0].shape) == (3, 2)
    view = tree.tree_map(lambda a: a[1], stacked)
    view["carry"][1].copy_(torch.full((3,), 7.0))       # writes through
    assert float(stacked["carry"][1][1].sum()) == 21.0
    summed = tree.tree_map(lambda a, b: a + b, t, t)
    assert float(summed["carry"][2]) == 4.0


def _trees(n, seed):
    r = np.random.default_rng(seed)
    return [{"a": {"w": r.normal(size=(3, 4)).astype(np.float32)},
             "b": r.normal(size=5).astype(np.float32)} for _ in range(n)]


def test_hierarchy_host_half_matches():
    h = HierarchyConfig(num_edge_servers=3, clients_per_es=4, kappa0=5,
                        kappa1=2)
    jhc = JH(num_edge_servers=3, clients_per_es=4, kappa0=5, kappa1=2)
    for t2, t1, t0 in ((0, 0, 0), (2, 1, 4), (7, 0, 3)):
        assert th.sgd_step_index(t2, t1, t0, h) == jh.sgd_step_index(
            t2, t1, t0, jhc)
    np.testing.assert_array_equal(th.normalized_weights([1, 2, 5]),
                                  jh.normalized_weights([1, 2, 5]))
    np.testing.assert_array_equal(th.es_assignment(12, 4),
                                  jh.es_assignment(12, 4))
    trees = _trees(4, 0)
    w = th.normalized_weights([3, 1, 1, 5])
    for t_fn, j_fn in ((th.edge_aggregate, jh.edge_aggregate),
                       (th.global_aggregate, jh.global_aggregate)):
        got = t_fn([tree.tree_map(torch.from_numpy, t) for t in trees], w)
        want = j_fn([jax.tree.map(jnp.asarray, t) for t in trees], w)
        np.testing.assert_allclose(got["a"]["w"].numpy(),
                                   np.asarray(want["a"]["w"]), rtol=1e-6)
        np.testing.assert_allclose(got["b"].numpy(), np.asarray(want["b"]),
                                   rtol=1e-6)
    with pytest.raises(AssertionError):
        th.edge_aggregate(trees[:2], [0.5, 0.6])


def test_rng_state_array_round_trips_and_matches():
    rng = np.random.default_rng(11)
    rng.random(5)
    arr = trng.rng_state_array(rng)
    np.testing.assert_array_equal(arr, jckpt.rng_state_array(rng))
    expect = rng.random(3)
    fresh = np.random.default_rng(0)
    trng.restore_rng_state(fresh, arr)
    np.testing.assert_array_equal(fresh.random(3), expect)
    with pytest.raises(ValueError, match="rng state"):
        trng.restore_rng_state(fresh, np.zeros(4, np.uint64))


@pytest.mark.parametrize("weighting", ["data", "uniform"])
def test_fedsim_aggregation_weights_match(weighting):
    kw = dict(num_edge_servers=2, clients_per_es=3, kappa0=1, kappa1=1,
              weighting=weighting)
    data = dict(image_size=16, train_per_class=20, test_per_class=5, seed=1)
    cfg = dict(image_size=16, conv1_filters=8, conv2_filters=16,
               fc_hidden=32)
    j = JFedSim(JCNNConfig(**cfg), j_data(6, 0.3, **data), JH(**kw), JT())
    t = FedSim(CNNConfig(**cfg), make_federated_image_data(6, 0.3, **data),
               HierarchyConfig(**kw), TrainConfig(), device="cpu")
    np.testing.assert_array_equal(t.alpha_u, j.alpha_u)
    np.testing.assert_array_equal(t.alpha_b, j.alpha_b)
    with pytest.raises(ValueError, match="clients"):
        FedSim(CNNConfig(**cfg), make_federated_image_data(5, 0.3, **data),
               HierarchyConfig(**kw), TrainConfig(), device="cpu")
