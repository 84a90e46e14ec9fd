"""Port parity for the sharding rules and every model's axes tree
(``repro_torch.sharding.rules``, the models' ``*_axes`` functions,
``repro_torch.launch.mesh``) against the reference's, exactly.

- Every arch's ``Model.axes()`` (and the CNN's ``axes``) equals the
  reference's tree, as nested dicts of tuples, and its paths are exactly
  those of the port's ``init`` (``abstract_params``, on the meta device).
- ``params_specs`` gives the reference's entries for every arch at full
  size on the production (16, 16) and (2, 16, 16) meshes in both modes,
  and ``add_client_axis`` its client prefix.  The reference reads a
  mesh's names and sizes only, so a stand-in object with those serves it
  (the production meshes have 256 and 512 devices).
- The cases of ``tests/test_sharding.py``: the basic rules, the
  divisibility fallback and no mesh axis used twice.
"""

from types import SimpleNamespace

import jax
import pytest
from jax.sharding import PartitionSpec as P

from repro.configs.registry import ARCHS as J_ARCHS
from repro.configs.registry import get_arch as j_get_arch
from repro.configs.phsfl_cnn import CNNConfig as JCNN
from repro.models import build_model as j_build
from repro.models import cnn as jcnn
from repro.sharding import rules as jrules
from repro_torch.configs.base import MeshConfig
from repro_torch.configs.phsfl_cnn import CNNConfig
from repro_torch.configs.registry import ARCHS, get_arch
from repro_torch.core.phsfl import abstract_params
from repro_torch.launch import mesh as tmesh
from repro_torch.models import cnn as tcnn
from repro_torch.models.registry import build_model
from repro_torch.sharding import (AbstractMesh, add_client_axis,
                                  params_specs, spec_for)
from repro_torch.utils.tree import axes_leaf, path_leaves

MESHES = {"16x16": False, "2x16x16": True}


def _meshes(multi):
    cfg = MeshConfig(multi_pod=multi)
    ours = tmesh.make_production_mesh(multi_pod=multi, abstract=True)
    ref = SimpleNamespace(axis_names=cfg.axes,
                          shape=dict(zip(cfg.axes, cfg.shape)))
    return ours, ref


def _flat_axes(tree, prefix=""):
    """{path: leaf} of a nested-dict axes (or spec) tree."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat_axes(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def _flat_specs_j(tree):
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, P))[0]
    return {"/".join(str(k.key) for k in path): tuple(s)
            for path, s in flat}


@pytest.fixture(scope="module")
def zoo():
    """Both sides' models and the reference's abstract params, a full
    config per arch (shapes only)."""
    out = {}
    for name in sorted(ARCHS):
        jm = j_build(j_get_arch(name))
        shapes = jax.eval_shape(lambda k, jm=jm: jm.init(k),
                                jax.random.PRNGKey(0))
        tm = build_model(get_arch(name))
        out[name] = (jm, shapes, tm, abstract_params(tm))
    return out


def test_every_arch_is_covered():
    assert sorted(ARCHS) == sorted(J_ARCHS)


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_axes_tree_matches_reference(zoo, name):
    jm, _, tm, tp = zoo[name]
    assert tm.axes() == jm.axes()
    got = _flat_axes(tm.axes())
    assert all(axes_leaf(a) for a in got.values())
    # exactly the paths of init, one name per dim
    shapes = {p: tuple(t.shape) for p, t in path_leaves(tp)}
    assert set(got) == set(shapes)
    for p, a in got.items():
        assert len(a) == len(shapes[p]), p


@pytest.mark.parametrize("name", ["xlstm-350m", "olmoe-1b-7b",
                                  "seamless-m4t-medium"])
def test_reduced_axes_tree_matches_reference(name):
    tm = build_model(get_arch(name).reduced())
    assert tm.axes() == j_build(j_get_arch(name).reduced()).axes()
    assert (set(_flat_axes(tm.axes()))
            == {p for p, _ in path_leaves(abstract_params(tm))})


def test_cnn_axes_match_reference():
    assert tcnn.axes(CNNConfig()) == jcnn.axes(JCNN())
    assert (set(_flat_axes(tcnn.axes(CNNConfig())))
            == {p for p, _ in path_leaves(tcnn.param_shapes(CNNConfig()))})


@pytest.mark.parametrize("mode", ["tp", "fsdp_tp"])
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("name", sorted(ARCHS))
def test_params_specs_match_reference(zoo, name, mesh, mode):
    jm, shapes, tm, tp = zoo[name]
    ours, ref = _meshes(MESHES[mesh])
    got = params_specs(tp, tm.axes(), ours, mode=mode)
    want = jrules.params_specs(shapes, jm.axes(), ref, mode=mode)
    assert _flat_axes(got) == _flat_specs_j(want)
    # the client prefix of the paper-faithful round
    assert (_flat_axes(add_client_axis(got, ours))
            == _flat_specs_j(jrules.add_client_axis(want, ref)))


@pytest.mark.parametrize("multi", [False, True])
def test_mesh_shapes_match_reference(multi):
    m = tmesh.make_production_mesh(multi_pod=multi, abstract=True)
    cfg = MeshConfig(multi_pod=multi)
    assert (m.axis_names, m.sizes) == (cfg.axes, cfg.shape)
    assert tmesh.num_chips(m) == (512 if multi else 256)
    assert tmesh.num_clients(m) == (32 if multi else 16)
    alt = tmesh.make_alt_mesh(abstract=True)
    assert (alt.axis_names, alt.sizes) == (("data", "model"), (32, 8))
    dbg = tmesh.make_debug_mesh(multi_pod=multi, abstract=True)
    assert tmesh.num_chips(dbg) == 8
    assert tmesh.num_clients(dbg) == 4


# ------------------------------------------- tests/test_sharding.py cases --
def _mesh(multi=False):
    return tmesh.make_production_mesh(multi_pod=multi, abstract=True)


def test_spec_for_basic_rules():
    mesh = _mesh()
    assert spec_for((12288, 33792), ("embed", "mlp"), mesh) == (None,
                                                                "model")
    assert spec_for((12288, 33792), ("embed", "mlp"), mesh,
                    mode="fsdp_tp") == ("data", "model")
    assert spec_for((256000, 12288), ("vocab", "embed"), mesh) == ("model",
                                                                   None)
    # two client axes on the multi-pod mesh: a tuple entry
    assert spec_for((12288, 33792), ("embed", "mlp"), _mesh(True),
                    mode="fsdp_tp") == (("pod", "data"), "model")


def test_spec_for_divisibility_fallback():
    mesh = _mesh()
    # 10 heads do not divide 16-way -> replicated
    assert spec_for((2560, 10, 256), ("embed", "heads", "head_dim"),
                    mesh) == (None, None, None)
    # 96 heads divide -> sharded
    assert spec_for((12288, 96, 128), ("embed", "heads", "head_dim"),
                    mesh) == (None, "model", None)
    # embed 1000 does not divide 32-way on the multi-pod fsdp mesh
    assert spec_for((1000, 512), ("embed", "mlp"), _mesh(True),
                    mode="fsdp_tp") == (None, "model")
    # kv heads shard only when the count divides
    assert spec_for((4096, 8, 128), ("embed", "kv_heads", "head_dim"),
                    mesh) == (None, None, None)
    assert spec_for((4096, 32, 128), ("embed", "kv_heads", "head_dim"),
                    mesh) == (None, "model", None)


def test_no_axis_used_twice():
    s = spec_for((512, 512), ("mlp", "mlp"), _mesh())
    assert s == ("model", None)
    s = spec_for((512, 512), ("embed", "embed"), _mesh(), mode="fsdp_tp")
    assert s == ("data", None)


def test_spec_rank_mismatch_and_tree_mismatch_raise():
    with pytest.raises(ValueError):
        spec_for((4, 4), ("embed",), _mesh())
    with pytest.raises(ValueError):
        params_specs({"a": {"w": SimpleNamespace(shape=(4,))}},
                     {"a": {"v": ("embed",)}}, _mesh())


@pytest.mark.parametrize("case", [
    ((12288, 33792), ("embed", "mlp")), ((2560, 10, 256),
                                         ("embed", "heads", "head_dim")),
    ((512, 512), ("mlp", "mlp")), ((1000, 512), ("embed", "mlp")),
    ((64, 2048, 1408), ("expert", "embed", "mlp")),
    ((4, 2560), ("conv", "lru")), ((26, 2560, 2560), ("stack", "lru",
                                                      "lru"))])
@pytest.mark.parametrize("mode", ["tp", "fsdp_tp"])
@pytest.mark.parametrize("multi", [False, True])
def test_spec_for_matches_reference(case, mode, multi):
    ours, ref = _meshes(multi)
    shape, axes = case
    assert spec_for(shape, axes, ours, mode) == tuple(
        jrules.spec_for(shape, axes, ref, mode))


def test_abstract_mesh_of_a_device_mesh_shape():
    m = AbstractMesh(("pod", "data", "model"), (2, 2, 1))
    assert m.shape == {"pod": 2, "data": 2, "model": 1}
    assert tmesh.num_clients(m) == 4 and tmesh.num_chips(m) == 4
