"""Port parity for ``repro_torch.core.split`` against ``repro.core.split``:
the part of every leaf path, the per-part parameter counts and the
trainable mask of each phase, for the paper's CNN at every cut and for the
three ported architectures' reduced configs at their default cut, at
cut=1 and (six layers: lead, scan and tail stages) at cut=2.  All equal
to the reference.  The reference's parameter shapes come from
``jax.eval_shape`` of its init; the port's from its own init, so the
two trees must also have the same paths and shapes."""

import functools

import jax
import pytest

from repro.configs.phsfl_cnn import CNNConfig as JCNN
from repro.configs.registry import get_arch as j_get_arch
from repro.core import split as jsplit
from repro.models import build_model as j_build
from repro.models import cnn as jcnn
from repro.utils.tree import map_with_path as j_map_with_path
from repro_torch.configs.phsfl_cnn import CNNConfig
from repro_torch.configs.registry import get_arch
from repro_torch.core import split as tsplit
from repro_torch.models import cnn
from repro_torch.models.registry import build_model
from repro_torch.utils.prng import make_generator
from repro_torch.utils.tree import path_leaves

ARCHS = ("gemma3-12b", "xlstm-350m", "recurrentgemma-2b")
SMALL = dict(image_size=16, conv1_filters=8, conv2_filters=16, fc_hidden=32)
PHASES = (tsplit.GLOBAL_TRAIN, tsplit.HSFL_TRAIN, tsplit.PERSONALIZE)


def _j_paths(tree):
    out = {}
    j_map_with_path(lambda p, x: out.setdefault(p, tuple(x.shape)), tree)
    return out


def _cases():
    for arch in ARCHS:
        for layers, cuts in ((2, (None, 1)), (6, (None, 1, 2))):
            for cut in cuts:
                yield pytest.param(arch, layers, cut,
                                   id=f"{arch}-L{layers}-cut{cut}")


@functools.lru_cache(maxsize=None)
def _lm(arch, layers):
    j_cfg = j_get_arch(arch).reduced(num_layers=layers)
    cfg = get_arch(arch).reduced(num_layers=layers)
    shapes = jax.eval_shape(lambda k: j_build(j_cfg).init(k),
                            jax.random.PRNGKey(0))
    params = build_model(cfg).init(make_generator(0))
    return j_cfg, cfg, shapes, params


def _check(j_cfg, cfg, shapes, params, cut):
    jspec = jsplit.split_spec_for(j_cfg, cut)
    tspec = tsplit.split_spec_for(cfg, cut)
    assert (tspec.client_patterns, tspec.head_patterns) == (
        jspec.client_patterns, jspec.head_patterns)
    want = _j_paths(shapes)
    got = {p: tuple(t.shape) for p, t in path_leaves(params)}
    assert got == want
    parts = {p: tspec.part_of(p) for p in got}
    assert parts == {p: jspec.part_of(p) for p in want}
    assert {"client", "head"} <= set(parts.values())
    assert tsplit.count_parts(params, tspec) == jsplit.count_parts(shapes,
                                                                   jspec)
    for phase in PHASES:
        tm = dict(path_leaves(tsplit.trainable_mask(params, tspec, phase)))
        jm = {}
        j_map_with_path(lambda p, m: jm.setdefault(p, m),
                        jsplit.trainable_mask(shapes, jspec, phase))
        assert tm == jm, phase
    for part, mask in tsplit.part_masks(params, tspec).items():
        jm = {}
        j_map_with_path(lambda p, m: jm.setdefault(p, m),
                        jsplit.part_masks(shapes, jspec)[part])
        assert dict(path_leaves(mask)) == jm, part


@pytest.mark.parametrize("arch,layers,cut", list(_cases()))
def test_lm_split_matches_reference(arch, layers, cut):
    _check(*_lm(arch, layers), cut)


@pytest.mark.parametrize("cut", [None] + list(cnn.CUT_CANDIDATES))
def test_cnn_split_matches_reference(cut):
    j_cfg, cfg = JCNN(**SMALL), CNNConfig(**SMALL)
    shapes = jax.eval_shape(lambda k: jcnn.init(k, j_cfg),
                            jax.random.PRNGKey(0))
    _check(j_cfg, cfg, shapes, cnn.init(0, cfg), cut)


def test_head_is_the_same_at_every_cut():
    """Remark 2: the cut moves the client/body boundary only; the head
    (all that the optimizer mask distinguishes) never moves."""
    cfg = get_arch("xlstm-350m").reduced(num_layers=6)
    params = build_model(cfg).init(make_generator(0))
    masks = [tsplit.trainable_mask(params, tsplit.split_spec_for(cfg, c),
                                   tsplit.GLOBAL_TRAIN) for c in (0, 1, 2)]
    assert masks[0] == masks[1] == masks[2]
    assert not masks[0]["lm_head"]["w"]


def test_unknown_phase_and_config_raise():
    cfg = get_arch("xlstm-350m").reduced()
    params = build_model(cfg).init(make_generator(0))
    with pytest.raises(ValueError):
        tsplit.trainable_mask(params, tsplit.split_spec_for(cfg), "nope")
    with pytest.raises(TypeError):
        tsplit.split_spec_for(object())
    with pytest.raises(ValueError):
        tsplit.split_spec_for(CNNConfig(**SMALL), "fc2")
