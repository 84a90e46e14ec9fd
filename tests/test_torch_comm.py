"""Port parity for the byte accounting (``repro_torch.core.comm``), its
FLOP helpers, and the Eq. 17/21 calculator (``core.theory``) against the
reference's.

Every quantity is an integer (bits, parameter counts) or a float computed
by the same expression from them, so the bar is exact equality, on every
(cut, codec) cell of the CNN and on the LM tables.  The reference counts
parameters with ``jax.eval_shape``; the port builds its trees on the meta
device, so the full-width LMs are counted here too without a weight
drawn.
"""

import dataclasses

import numpy as np
import pytest

from repro.compress import link_codecs as j_link_codecs
from repro.configs.phsfl_cnn import CNNConfig as JCNNConfig
from repro.configs.registry import get_arch as j_get_arch
from repro.core import comm as jcomm
from repro.core import theory as jtheory
from repro_torch.compress import link_codecs
from repro_torch.configs.phsfl_cnn import CNNConfig
from repro_torch.configs.registry import get_arch
from repro_torch.core import comm, theory
from repro_torch.core.comm import CommModel
from repro_torch.models import cnn
from repro_torch.utils import flops

NUMBERS = ("omega", "batch_size", "batches_per_epoch", "cut_size",
           "client_params", "total_params", "dataset_size",
           "client_flops_per_sample")


def _assert_same_model(got, want, tag=""):
    for f in NUMBERS:
        a, b = getattr(got, f), getattr(want, f)
        assert a == b and type(a) is type(b), (tag, f, a, b)
    for m in ("phi_activation_bits", "phi_activation_up_bits",
              "phi_grad_down_bits", "phi_indices_bits", "phi_local_bits",
              "phi_off_bits", "phi_hfl_bits"):
        assert getattr(got, m)() == getattr(want, m)(), (tag, m)
    for k0 in (1, 2, 5):
        assert got.phi_phsfl_bits(k0) == want.phi_phsfl_bits(k0), (tag, k0)
        assert got.phsfl_wins(k0) == want.phsfl_wins(k0), (tag, k0)


CODECS = {"none": ({}, None), "fp32": ({}, "fp32"), "int8": ({}, "int8"),
          "int4": ({}, "int4"), "int6": ({"bits": 6}, "int8"),
          "topk": ({"topk_frac": 0.1}, "topk"), "fp8": ({}, "fp8")}


def _codecs(key):
    kw, name = CODECS[key]
    if name is None:
        return None, None
    return link_codecs(name, **kw), j_link_codecs(name, **kw)


CNNS = {"paper": {}, "small": dict(image_size=16, conv1_filters=8,
                                   conv2_filters=16, fc_hidden=32)}


@pytest.mark.parametrize("codec", sorted(CODECS))
@pytest.mark.parametrize("cut", cnn.CUT_CANDIDATES)
@pytest.mark.parametrize("net", sorted(CNNS))
def test_cnn_cell_matches_reference(net, cut, codec):
    tc, jc = _codecs(codec)
    for kw in (dict(dataset_size=500), dict(dataset_size=1, omega=16,
                                            batch_size=16,
                                            batches_per_epoch=3)):
        got = comm.comm_for_cnn(CNNConfig(**CNNS[net]), cut=cut, codecs=tc,
                                **kw)
        want = jcomm.comm_for_cnn(JCNNConfig(**CNNS[net]), cut=cut,
                                  codecs=jc, **kw)
        _assert_same_model(got, want, (net, cut, codec, kw))


def test_cnn_tables_match_reference():
    grid = {k: _codecs(k) for k in ("fp32", "int8", "topk")}
    got = comm.comm_table_for_cnn(CNNConfig(), dataset_size=400,
                                  codecs={k: v[0] for k, v in grid.items()})
    want = jcomm.comm_table_for_cnn(JCNNConfig(), dataset_size=400,
                                    codecs={k: v[1] for k, v in grid.items()})
    assert list(got) == list(want)
    for key in want:
        _assert_same_model(got[key], want[key], key)
    got = comm.comm_table_for_cnn(CNNConfig(), dataset_size=400, cuts=())
    want = jcomm.comm_table_for_cnn(JCNNConfig(), dataset_size=400, cuts=())
    assert tuple(got) == tuple(want) == cnn.CUT_CANDIDATES
    for key in want:
        _assert_same_model(got[key], want[key], key)


LMS = ("xlstm-350m", "gemma3-12b", "recurrentgemma-2b", "olmoe-1b-7b",
       "deepseek-v2-236b", "qwen2-vl-7b", "command-r-plus-104b",
       "mistral-large-123b", "gemma3-27b")


@pytest.mark.parametrize("arch", LMS)
def test_lm_full_width_matches_reference(arch):
    """Full width, counted from shapes alone on both sides."""
    got = comm.comm_for_lm(get_arch(arch), seq_len=2048,
                           dataset_size=10_000)
    want = jcomm.comm_for_lm(j_get_arch(arch), seq_len=2048,
                             dataset_size=10_000)
    _assert_same_model(got, want, arch)
    assert got.client_params < got.total_params


@pytest.mark.parametrize("arch", LMS)
def test_lm_tables_match_reference(arch):
    tc, jc = _codecs("int8")
    cfg, jcfg = get_arch(arch).reduced(), j_get_arch(arch).reduced()
    kw = dict(seq_len=64, dataset_size=100, batch_size=2, cuts=(1, 2))
    got = comm.comm_table_for_lm(cfg, codecs={"fp32": None, "int8": tc},
                                 **kw)
    want = jcomm.comm_table_for_lm(jcfg, codecs={"fp32": None, "int8": jc},
                                   **kw)
    assert list(got) == list(want)
    for key in want:
        _assert_same_model(got[key], want[key], (arch, key))
    with pytest.raises(ValueError, match="cuts"):
        comm.comm_table_for_lm(cfg, seq_len=64, dataset_size=100, cuts=())


@pytest.mark.parametrize("ds", [0, 1, 2, 1 << 20])
def test_index_bits_match_reference(ds):
    got = CommModel(batch_size=16, dataset_size=ds)
    want = jcomm.CommModel(batch_size=16, dataset_size=ds)
    _assert_same_model(got, want, ds)


def test_flop_helpers_match_reference():
    from repro.utils import flops as jflops
    for n, d in ((1, 1), (443_415_552, 2048), (7, 3)):
        assert flops.dense_model_flops(n, d) == jflops.dense_model_flops(n, d)
        assert flops.training_flops(n) == jflops.training_flops(n)


def test_param_shapes_draw_nothing():
    tree = cnn.param_shapes(CNNConfig())
    leaves = [t for sub in tree.values() for t in sub.values()]
    assert all(t.device.type == "meta" for t in leaves)
    real = cnn.init(0, CNNConfig())
    assert {k: {n: tuple(t.shape) for n, t in v.items()}
            for k, v in tree.items()} == {
        k: {n: tuple(t.shape) for n, t in v.items()}
        for k, v in real.items()}


# ------------------------------------------------------------ the bound ----
def _inputs(mod, seed, **over):
    rng = np.random.default_rng(seed)
    au = rng.random((4, 25))
    au /= au.sum(axis=1, keepdims=True)
    ab = rng.random(4)
    ab /= ab.sum()
    kw = dict(eta=10 ** rng.uniform(-4, -1), beta=rng.uniform(0.5, 2.0),
              sigma2=rng.uniform(0.1, 2.0), eps0_2=rng.uniform(0.1, 5.0),
              eps1_2=rng.uniform(0.1, 5.0), kappa0=int(rng.integers(1, 9)),
              kappa1=int(rng.integers(1, 5)), T=1500,
              f0_minus_fT=rng.uniform(0.5, 3.0), alpha_u=au, alpha_b=ab)
    kw.update(over)
    return mod.BoundInputs(**kw)


@pytest.mark.parametrize("seed", range(6))
def test_bound_terms_match_reference(seed):
    got = theory.bound_terms(_inputs(theory, seed))
    want = jtheory.bound_terms(_inputs(jtheory, seed))
    assert got == want
    assert theory.lr_limit(1.3, 5, 3) == jtheory.lr_limit(1.3, 5, 3)
    for a, b in zip(theory.uniform_weights(3, 7),
                    jtheory.uniform_weights(3, 7)):
        assert np.array_equal(a, b)


def test_comm_model_fields_are_the_reference_fields():
    assert [f.name for f in dataclasses.fields(CommModel)] == [
        f.name for f in dataclasses.fields(jcomm.CommModel)]
