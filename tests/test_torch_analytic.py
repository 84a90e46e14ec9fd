"""Port parity for the launch tools' arithmetic: ``repro_torch.configs.
{base.ShapeConfig, shapes, registry.supports_shape}``,
``repro_torch.launch.analytic`` and ``roofline.{active_params,
model_flops_for}`` against the reference's, held EQUAL (every float, every
``detail`` entry) for every arch x the four shapes (where supported) x the
production meshes (16, 16), (2, 16, 16) and the alternative (32, 8), in
both train modes, both serving param modes, both ``attn_impl`` values,
aggregation in 2 and 4 bytes and the three remat settings.

The reference counts parameters with a full-width ``jax.eval_shape``
(seconds each at command-r-plus): the module fixture memoizes its
``param_bytes_global`` and ``active_params`` by config for this file,
through a ``MonkeyPatch`` undone at the end, so each arch's count is
taken once.  The port counts on the meta device.
"""

import dataclasses
import functools

import pytest

from repro.configs import registry as ref_registry
from repro.configs import shapes as ref_shapes
from repro.configs.base import TrainConfig as RefTrainConfig
from repro.launch import analytic as ref_analytic
from repro.launch import roofline as ref_roofline
from repro_torch.configs import registry, shapes
from repro_torch.configs.base import TrainConfig
from repro_torch.launch import analytic, roofline

MESHES = ({"data": 16, "model": 16}, {"pod": 2, "data": 16, "model": 16},
          {"data": 32, "model": 8})
REMAT = ({}, {"remat": False}, {"remat_policy": "dots"})
ARCHS = sorted(registry.ARCHS)


@pytest.fixture(scope="module", autouse=True)
def shared_reference_counts():
    mp = pytest.MonkeyPatch()
    pb = functools.lru_cache(maxsize=None)(ref_analytic.param_bytes_global)
    ap = functools.lru_cache(maxsize=None)(ref_roofline.active_params)
    mp.setattr(ref_analytic, "param_bytes_global", pb)
    mp.setattr(ref_roofline, "active_params", ap)
    yield
    mp.undo()


def _ref_cfg(name):
    return ref_registry.get_arch(name)


def _same(a, b):
    assert (a.flops, a.hbm_bytes, a.coll_bytes) == (b.flops, b.hbm_bytes,
                                                    b.coll_bytes)
    assert a.detail == b.detail


def test_shapes_and_support_equal():
    for name, s in ref_shapes.SHAPES.items():
        assert dataclasses.asdict(shapes.SHAPES[name]) == \
            dataclasses.asdict(s)
    assert list(shapes.SHAPES) == list(ref_shapes.SHAPES)
    assert [f.name for f in dataclasses.fields(shapes.SHAPES["train_4k"])] \
        == [f.name for f in dataclasses.fields(ref_shapes.TRAIN_4K)]
    assert registry.LONG_CONTEXT_OK == ref_registry.LONG_CONTEXT_OK
    for arch in ref_registry.ARCHS:
        for s in ref_shapes.SHAPES:
            assert registry.supports_shape(arch, s) == \
                ref_registry.supports_shape(arch, s)


@pytest.mark.parametrize("arch", ARCHS)
def test_counts_and_forward_flops_equal(arch):
    cfg, rc = registry.get_arch(arch), _ref_cfg(arch)
    assert analytic.param_bytes_global(cfg) == \
        ref_analytic.param_bytes_global(rc)
    assert roofline.active_params(cfg) == ref_roofline.active_params(rc)
    for kv in (1, 1000.5, 4096, 32768, 524288):
        for half in (False, True):
            assert analytic.forward_flops_per_token(cfg, kv, causal_half=half) \
                == ref_analytic.forward_flops_per_token(rc, kv,
                                                        causal_half=half)
    for name, s in shapes.SHAPES.items():
        assert roofline.model_flops_for(cfg, s, s.kind) == \
            ref_roofline.model_flops_for(rc, ref_shapes.SHAPES[name], s.kind)


@pytest.mark.parametrize("arch", ARCHS)
def test_costs_equal(arch):
    cfg, rc = registry.get_arch(arch), _ref_cfg(arch)
    n = 0
    for name, s in shapes.SHAPES.items():
        if not registry.supports_shape(arch, name):
            continue
        rs = ref_shapes.SHAPES[name]
        for mesh in MESHES:
            if s.kind == "train":
                for mode in ("paper_faithful", "shared_server"):
                    for impl in ("masked", "flash"):
                        for agg in (2, 4):
                            for kw in REMAT:
                                t, rt = TrainConfig(**kw), RefTrainConfig(**kw)
                                _same(analytic.train_cost(
                                    cfg, s, mesh, tcfg=t, mode=mode,
                                    attn_impl=impl, agg_dtype_bytes=agg),
                                    ref_analytic.train_cost(
                                        rc, rs, mesh, tcfg=rt, mode=mode,
                                        attn_impl=impl, agg_dtype_bytes=agg))
                                n += 1
                            _same(analytic.cost_for(
                                cfg, s, mesh, mode=mode, attn_impl=impl,
                                agg_dtype_bytes=agg),
                                ref_analytic.cost_for(
                                    rc, rs, mesh, mode=mode, attn_impl=impl,
                                    agg_dtype_bytes=agg))
            else:
                for pm in ("fsdp_tp", "tp"):
                    if s.kind == "prefill":
                        for impl in ("masked", "flash"):
                            _same(analytic.prefill_cost(
                                cfg, s, mesh, attn_impl=impl, param_mode=pm),
                                ref_analytic.prefill_cost(
                                    rc, rs, mesh, attn_impl=impl,
                                    param_mode=pm))
                            n += 1
                    else:
                        _same(analytic.decode_cost(cfg, s, mesh,
                                                   param_mode=pm),
                              ref_analytic.decode_cost(rc, rs, mesh,
                                                       param_mode=pm))
                        n += 1
                    _same(analytic.cost_for(cfg, s, mesh, param_mode=pm),
                          ref_analytic.cost_for(rc, rs, mesh, param_mode=pm))
    assert n > 0


def test_trainconfig_defaults_equal():
    # the cost model reads TrainConfig's defaults (local steps, remat)
    assert dataclasses.asdict(TrainConfig()) == \
        dataclasses.asdict(RefTrainConfig())
