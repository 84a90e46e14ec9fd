"""The port's package-level API: every name of the reference packages'
``__all__`` imports from the port's counterpart package, and the tree,
flop and seed utilities behind ``repro_torch.utils`` compute what the
reference's compute on the same numpy inputs.

The reference's ``__init__`` files are read by AST, so a reference
package that fails to import here (``repro.wireless``, R1 in ROADMAP.md)
still lists its names.
"""

import ast
import importlib
import itertools
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.utils import flops as j_flops
from repro.utils import tree as j_tree
from repro_torch import utils as t_utils
from repro_torch.utils import flops as t_flops
from repro_torch.utils import prng as t_prng

ROOT = Path(__file__).resolve().parent.parent
REFERENCE = ROOT / "src" / "repro"

# the reference's names the port does not carry, each with its port
# counterpart or the reason; nothing else may be missing
EXCLUDED = {
    ("sharding", "named_sharding"):
        "repro_torch.sharding.rules.shard_params / gather_params: the "
        "port cuts a rank's block itself (no jax.NamedSharding)",
    ("sharding", "constrain"):
        "no caller: the reference defines it and nothing calls it",
}
# the packages whose __init__ this slice wrote: the reference's order too
SAME_ORDER = ("configs", "core", "models", "utils")


def _reference_all(init: Path):
    for node in ast.parse(init.read_text()).body:
        if isinstance(node, ast.Assign) and any(
                getattr(t, "id", None) == "__all__" for t in node.targets):
            return ast.literal_eval(node.value)
    return None


def _packages():
    out = {}
    for init in sorted(REFERENCE.glob("*/__init__.py")):
        names = _reference_all(init)
        if names is not None:
            out[init.parent.name] = names
    return out


PACKAGES = _packages()


def test_reference_packages_found():
    assert set(SAME_ORDER) <= set(PACKAGES)
    assert {"checkpoint", "compress", "sharding", "telemetry",
            "wireless"} <= set(PACKAGES)
    assert len(PACKAGES["core"]) == 44 and len(PACKAGES["utils"]) == 18


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_every_reference_name_imports_from_the_port(pkg):
    mod = importlib.import_module(f"repro_torch.{pkg}")
    want = [n for n in PACKAGES[pkg] if (pkg, n) not in EXCLUDED]
    missing = [n for n in want if not hasattr(mod, n)]
    assert not missing, f"repro_torch.{pkg} lacks {missing}"
    unlisted = [n for n in want if n not in mod.__all__]
    assert not unlisted, f"repro_torch.{pkg}.__all__ lacks {unlisted}"
    if pkg in SAME_ORDER:
        assert mod.__all__[:len(want)] == want


def test_exclusions_are_the_only_missing_names():
    """The exclusion table names only what the port really lacks, and
    each counterpart it names exists."""
    for pkg, name in EXCLUDED:
        assert name in PACKAGES[pkg]
        assert not hasattr(importlib.import_module(f"repro_torch.{pkg}"),
                           name)
    from repro_torch.sharding import rules
    assert callable(rules.shard_params) and callable(rules.gather_params)


# -------------------------------------------------------------- the trees --

def _numpy_tree(seed=0):
    """Dict keys out of order, a tuple, a list, a None subtree, mixed
    dtypes: the cases where the reference's flattening order shows."""
    rng = np.random.default_rng(seed)
    return {
        "zeta": {"w": rng.standard_normal((3, 4)).astype(np.float32),
                 "b": rng.standard_normal(4).astype(np.float32)},
        "alpha": (rng.standard_normal(5).astype(np.float64),
                  np.arange(6, dtype=np.int32).reshape(2, 3)),
        "mid": [rng.standard_normal((2, 2)).astype(np.float16),
                {"k": np.array([True, False])}],
        "empty": None,
        "head": {"kernel": rng.standard_normal((4, 2)).astype(np.float32)},
    }


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_to_torch(v) for v in tree)
    return None if tree is None else torch.from_numpy(np.array(tree))


def _to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_to_numpy(v) for v in tree)
    if isinstance(tree, (torch.Tensor, jax.Array)):
        return np.asarray(tree)
    return tree


def _assert_trees_equal(got, want):
    """Same structure (dict keys as sets, sequences in order, None
    where None) and bit-equal leaves of the same dtype."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want)
        for k in want:
            _assert_trees_equal(got[k], want[k])
    elif isinstance(want, (tuple, list)):
        assert type(got) is type(want) and len(got) == len(want)
        for a, b in zip(got, want):
            _assert_trees_equal(a, b)
    elif want is None or isinstance(want, bool):
        assert got is want
    else:
        a, b = np.asarray(got), np.asarray(want)
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()


IS_LEAF = {"none": None,
           "tuple_leaves": lambda x: isinstance(x, tuple)}


@pytest.mark.parametrize("is_leaf", sorted(IS_LEAF))
def test_tree_paths_and_path_str_match_reference(is_leaf):
    tree = _numpy_tree()
    fn = IS_LEAF[is_leaf]
    want = j_tree.tree_paths(tree, is_leaf=fn)
    assert t_utils.tree_paths(_to_torch(tree), is_leaf=fn) == want
    # path_str renders a key path: the reference's jax keys, the port's
    # plain keys and indices
    flat, _ = jax.tree_util.tree_flatten_with_path(tree, is_leaf=fn)
    for path, _ in flat:
        plain = tuple(getattr(p, "key", getattr(p, "idx", None))
                      for p in path)
        assert t_utils.path_str(plain) == j_tree.path_str(path)
    if is_leaf == "none":
        assert want[:2] == ["alpha/0", "alpha/1"] and "empty" not in want


@pytest.mark.parametrize("patterns", [["^zeta/"], ["kernel$", "alpha"],
                                      [r"mid/1/k"], ["nomatch"]],
                         ids=lambda p: "|".join(p))
def test_mask_merge_select_match_reference(patterns):
    tree = _numpy_tree()
    other = _numpy_tree(seed=1)
    jmask = j_tree.mask_by_path(tree, patterns)
    tmask = t_utils.mask_by_path(_to_torch(tree), patterns)
    _assert_trees_equal(tmask, jmask)
    _assert_trees_equal(
        _to_numpy(t_utils.merge_trees(tmask, _to_torch(tree),
                                      _to_torch(other))),
        _to_numpy(j_tree.merge_trees(jmask, tree, other)))
    _assert_trees_equal(_to_numpy(t_utils.select_tree(tmask,
                                                      _to_torch(tree))),
                        _to_numpy(j_tree.select_tree(jmask, tree)))


def test_size_bytes_zeros_like_match_reference():
    tree = _numpy_tree()
    t = _to_torch(tree)
    assert t_utils.tree_size(t) == j_tree.tree_size(tree)
    assert t_utils.tree_bytes(t) == j_tree.tree_bytes(tree)
    assert t_utils.tree_size(t) == 12 + 4 + 5 + 6 + 4 + 2 + 8
    # jax without x64 makes float32 zeros of a float64 leaf; the port
    # keeps the leaf's dtype, so that leaf is held in float32 here
    tree["alpha"] = (tree["alpha"][0].astype(np.float32), tree["alpha"][1])
    _assert_trees_equal(_to_numpy(t_utils.tree_zeros_like(_to_torch(tree))),
                        _to_numpy(j_tree.tree_zeros_like(tree)))
    assert t_utils.tree_zeros_like(t)["alpha"][0].dtype == torch.float64


def _poisoned(value):
    tree = {k: v for k, v in _numpy_tree().items() if v is not None}
    tree["zeta"]["w"] = tree["zeta"]["w"].copy()
    tree["zeta"]["w"][1, 2] = value
    return tree


ALLFINITE = {
    "finite": lambda: {k: v for k, v in _numpy_tree().items()
                       if v is not None},
    "nan": lambda: _poisoned(np.nan),
    "inf": lambda: _poisoned(np.inf),
    "neg_inf_half": lambda: {"h": np.array([1.0, -np.inf], np.float16),
                             "i": np.arange(3)},
    "integers_only": lambda: {"i": np.arange(3, dtype=np.int32),
                              "b": np.array([True])},
}


@pytest.mark.parametrize("case", sorted(ALLFINITE))
def test_tree_allfinite_matches_reference(case):
    tree = ALLFINITE[case]()
    got = t_utils.tree_allfinite(_to_torch(tree))
    want = j_tree.tree_allfinite(tree)
    assert isinstance(got, torch.Tensor) and got.dim() == 0
    assert got.dtype == torch.bool
    assert bool(got) == bool(want)
    assert bool(got) == (case in ("finite", "integers_only"))


@pytest.mark.parametrize("dtype", [np.float32, np.float16, np.float64])
def test_tree_l2_distance_matches_reference(dtype):
    rng = np.random.default_rng(3)
    a = {"x": rng.standard_normal((64, 33)).astype(dtype),
         "y": (rng.standard_normal(7).astype(dtype),
               {"z": rng.standard_normal((5, 5)).astype(dtype)})}
    b = {"x": rng.standard_normal((64, 33)).astype(dtype),
         "y": (rng.standard_normal(7).astype(dtype),
               {"z": rng.standard_normal((5, 5)).astype(dtype)})}
    got = t_utils.tree_l2_distance(_to_torch(a), _to_torch(b))
    want = j_tree.tree_l2_distance(a, b)
    assert got.dtype == torch.float32 and got.dim() == 0
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    assert float(t_utils.tree_l2_distance(_to_torch(a), _to_torch(a))) == 0


# -------------------------------------------------------------- the flops --

FLOP_FUNCTIONS = ("matmul_flops", "dense_model_flops",
                  "forward_model_flops", "attention_flops", "conv2d_flops",
                  "dense_layer_flops", "training_flops")


@pytest.mark.parametrize("name", FLOP_FUNCTIONS)
def test_flop_counts_match_reference(name):
    import inspect
    fn, ref = getattr(t_flops, name), getattr(j_flops, name)
    params = [p for p in inspect.signature(ref).parameters.values()
              if p.kind != p.KEYWORD_ONLY]
    assert [p.name for p in inspect.signature(fn).parameters.values()] == \
        list(inspect.signature(ref).parameters)
    grid = (1, 3, 128, 4097)
    for args in itertools.product(grid, repeat=len(params)):
        assert fn(*args) == ref(*args), args
        if name == "attention_flops":
            assert fn(*args, backward=True) == ref(*args, backward=True)


# --------------------------------------------------------------- the seeds --

def test_key_iter_is_a_deterministic_stream_of_distinct_seeds():
    n = 2000
    a = list(itertools.islice(t_utils.key_iter(7), n))
    b = list(itertools.islice(t_utils.key_iter(7), n))
    c = list(itertools.islice(t_utils.key_iter(8), n))
    assert a == b
    assert len(set(a)) == n and not set(a) & set(c)
    assert all(isinstance(s, int) and 0 <= s < 2 ** t_prng.SEED_BITS
               for s in a)
    # each seed is the port's fold_in of the parent and the index
    assert a[:3] == [t_prng.fold_in(7, i) for i in range(3)]
    g0, g1 = (t_prng.make_generator(s) for s in a[:2])
    assert not torch.equal(torch.rand(4, generator=g0),
                           torch.rand(4, generator=g1))
