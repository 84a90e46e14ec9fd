"""Port parity for the whole slice: the reference ``FedSim`` and the port's
``FedSim`` on the same data and seed, the reference's initial parameters
carried in through ``load_state_dict``, two global rounds, then
``personalize``.
"""

import numpy as np
import pytest
import torch

import jax

from repro.compress import link_codecs as j_link_codecs
from repro.configs.base import HierarchyConfig as JH, TrainConfig as JT
from repro.configs.phsfl_cnn import CNNConfig as JCNNConfig
from repro.core.fedsim import FedSim as JFedSim
from repro.data.synthetic import make_federated_image_data as j_data
from repro_torch.compress import link_codecs
from repro_torch.configs import CNNConfig, HierarchyConfig, TrainConfig
from repro_torch.core.fedsim import FedSim
from repro_torch.data.synthetic import make_federated_image_data
from repro_torch.utils.tree import tree_leaves

SMALL = dict(image_size=16, conv1_filters=8, conv2_filters=16, fc_hidden=32)
H = dict(num_edge_servers=2, clients_per_es=2, kappa0=2, kappa1=2,
         global_rounds=2)
T = dict(learning_rate=0.05, batch_size=8, finetune_steps=3, finetune_lr=0.05)
DATA = dict(image_size=16, train_per_class=30, test_per_class=10, seed=0)


def _jax_run(codecs):
    jsim = JFedSim(JCNNConfig(**SMALL), j_data(4, 0.5, **DATA), JH(**H),
                   JT(**T), batches_per_epoch=2, seed=0, codecs=codecs)
    state = jsim.state_dict()
    state["params"] = jax.tree.map(np.asarray, state["params"])
    res = jsim.run(rounds=2, log_every=1)
    heads, per = jsim.personalize(res.global_params)
    return state, res, heads, per


def _port_sim(codecs=None, **kw):
    return FedSim(CNNConfig(**SMALL), make_federated_image_data(4, 0.5,
                                                                **DATA),
                  HierarchyConfig(**H), TrainConfig(**T),
                  batches_per_epoch=2, seed=0, codecs=codecs, device="cpu",
                  **kw)


def _port_run(state, codecs):
    sim = _port_sim(codecs)
    sim.load_state_dict(state)
    res = sim.run(rounds=2, log_every=1)
    heads, per = sim.personalize(res.global_params)
    return res, heads, per


# Tolerances per case: (rtol, atol) on losses and parameters, and how many
# test samples a client's accuracy may differ by.  No codec: the two sides
# differ only by float32 summation order in their convolution and matmul
# kernels, compounded over 16 SGD steps (measured: 3e-7 at most), so
# 1e-4 and the same accuracies.  Deterministic int8: the jitted JAX side
# computes x*inv+u with other roundings than the eager ops the port
# matches (test_compress.py notes this), so a value on a rounding boundary
# moves by one quantum (absmax/127 of its tensor) on one side only, and
# training carries the perturbation on (measured: 3e-3 on losses, 1.2e-3
# on parameters); so 1e-2, and one test sample per client may flip.
CASES = {"none": (None, None, (1e-4, 1e-5), 0),
         "int8-det": (j_link_codecs("int8", stochastic=False),
                      link_codecs("int8", stochastic=False), (1e-2, 1e-2),
                      1)}


def _assert_acc_close(got, want, n_test, samples):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert (np.abs(got - want) <= samples / n_test + 1e-6).all(), (got, want)


@pytest.mark.parametrize("case", list(CASES))
def test_fedsim_matches_jax(case):
    jc, tc, (rtol, atol), samples = CASES[case]
    state, jres, jheads, jper = _jax_run(jc)
    tres, theads, tper = _port_run(state, tc)
    data = make_federated_image_data(4, 0.5, **DATA)
    n_test = np.array([min(len(i), 256) for i in data.test_indices])
    assert len(tres.history) == len(jres.history) == 2
    for a, b in zip(tres.history, jres.history):
        assert a["round"] == b["round"]
        for k in ("train_loss", "test_loss"):
            np.testing.assert_allclose(a[k], b[k], rtol=rtol, atol=atol,
                                       err_msg=k)
        # test_acc is the mean of the per-client accuracies
        _assert_acc_close(a["test_acc"], b["test_acc"], n_test.min(),
                          samples)
    for t_per, j_per in ((tres.per_client_global, jres.per_client_global),
                         (tper, jper)):
        np.testing.assert_allclose(t_per["loss"], np.asarray(j_per["loss"]),
                                   rtol=rtol, atol=atol)
        _assert_acc_close(t_per["acc"], j_per["acc"], n_test, samples)
    for k in jres.global_params:
        for n in jres.global_params[k]:
            np.testing.assert_allclose(
                tres.global_params[k][n].numpy(),
                np.asarray(jres.global_params[k][n]), rtol=rtol,
                atol=atol, err_msg=f"{k}/{n}")
    assert tuple(theads["w"].shape) == jheads["w"].shape == (4, 32, 10)
    for n in ("w", "b"):
        np.testing.assert_allclose(theads[n].numpy(),
                                   np.asarray(jheads[n]), rtol=rtol,
                                   atol=atol, err_msg=n)


def test_identity_codec_run_bit_identical_to_no_codec():
    base = _port_sim().run(rounds=2, log_every=1)
    ident = _port_sim(link_codecs("fp32")).run(rounds=2, log_every=1)
    assert base.history == ident.history
    for a, b in zip(tree_leaves(base.global_params),
                    tree_leaves(ident.global_params)):
        assert torch.equal(a, b)


def test_stochastic_int8_trains_and_is_reproducible():
    a = _port_sim(link_codecs("int8")).run(rounds=2, log_every=1)
    b = _port_sim(link_codecs("int8")).run(rounds=2, log_every=1)
    base = _port_sim().run(rounds=2, log_every=1)
    assert a.history == b.history                  # seeded codec stream
    assert a.history[-1]["train_loss"] != base.history[-1]["train_loss"]
    assert np.isfinite(a.history[-1]["test_loss"])
    assert a.history[-1]["test_acc"] > 0.2         # above 10-class chance


def test_state_dict_resumes_bit_identically():
    full = _port_sim(link_codecs("int8")).run(rounds=2, log_every=1)
    first = _port_sim(link_codecs("int8"))
    first.run(rounds=1, log_every=1)
    resumed = _port_sim(link_codecs("int8"))
    resumed.load_state_dict(first.state_dict())
    res = resumed.run(rounds=2, log_every=1)
    assert res.history == full.history[1:]
    for a, b in zip(tree_leaves(res.global_params),
                    tree_leaves(full.global_params)):
        assert torch.equal(a, b)


def test_head_frozen_in_training_and_moves_in_personalize():
    sim = _port_sim()
    sim._ensure_initialized()
    w0 = sim._stacked["fc2"]["w"][0].clone()
    res = sim.run(rounds=2, log_every=1)
    # Eq. (12): aggregation of identical head replicas moves them by ulps
    torch.testing.assert_close(res.global_params["fc2"]["w"], w0, rtol=0,
                               atol=1e-6)
    heads, _ = sim.personalize(res.global_params)
    assert not torch.allclose(heads["w"][0], w0)
    # the fine-tuning stream is its own: the same heads again
    again, _ = sim.personalize(res.global_params)
    assert torch.equal(again["w"], heads["w"])


def test_entry_point_needs_a_card_or_an_explicit_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FedSim(CNNConfig(**SMALL), make_federated_image_data(4, 0.5, **DATA),
               HierarchyConfig(**H), TrainConfig(**T))


def test_ideal_network_config_is_the_ideal_path():
    """``WirelessConfig(model="ideal")`` builds no scheduler: the run is
    the one without a network config, bit for bit."""
    from repro_torch.configs import WirelessConfig
    sim = _port_sim(wireless=WirelessConfig(model="ideal"))
    assert sim.scheduler is None
    res = sim.run(rounds=1, log_every=1)
    base = _port_sim().run(rounds=1, log_every=1)
    assert res.history == base.history and res.network == []
