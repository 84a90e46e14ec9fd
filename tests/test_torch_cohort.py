"""The port's population-scale decision core (``repro_torch.wireless.
scheduler_core`` through ``population.CohortScheduler``, float64 tensors
on the CPU) against the port's numpy oracle, which
``test_torch_wireless_oracle.py`` holds bit-identical to the reference's.

- Bit-identical ``RoundReport``s and carried state over the 20
  configurations x 6 rounds, under a pinned cohort mask, and across a
  ``state_dict`` resume (``tests/test_population.py``'s bar).
- The two ordered sums the core writes out: per-group sums in
  ``np.bincount``'s order, on adversarial values at 10**5 clients, and
  the pipelined columns in ``np.sum(axis=1)``'s pairwise order.
- ``Population`` (numpy, host) draws what the reference's draws: layout,
  k-means, every sampling rule, cohorts; and population mode end to end.
On the card the same core is held to the oracle by
``chip_smoke.check_cohort``, at U = 8 and at 10**5 clients.
"""

import numpy as np
import pytest
import torch

from test_torch_wireless_oracle import (CARRIED, CONFIGS, U,
                                        assert_reports_equal, port_scheduler,
                                        reference_wireless)

from repro_torch.configs.base import WirelessConfig
from repro_torch.configs.phsfl_cnn import CONFIG as CNN_CFG
from repro_torch.core.comm import comm_for_cnn
from repro_torch.wireless import make_scheduler
from repro_torch.wireless.population import (CohortScheduler, Population,
                                             cohort_report, kmeans_assign,
                                             make_cohort_scheduler)
from repro_torch.wireless.scheduler_core import (_rowsum_np_order,
                                                 segment_sum_np_order)

BASE = dict(mean_uplink_mbps=8.0, mean_downlink_mbps=30.0, latency_s=0.01,
            deadline_s=1.5, energy_budget_j=20.0, tx_power_w=0.7,
            heterogeneity=0.5, seed=3)


def _pair(name):
    return (port_scheduler(name),
            port_scheduler(name, cls=CohortScheduler, core_device="cpu"))


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_core_matches_oracle(name):
    oracle, core = _pair(name)
    assert type(core).__name__ == "CohortScheduler"
    for r in range(6):
        assert_reports_equal(core.step(r), oracle.step(r), f"{name} r{r}")
    for attr in CARRIED:
        assert np.array_equal(getattr(core, attr), getattr(oracle, attr)), \
            (name, attr)


@pytest.mark.parametrize("name", ["contend_prop", "topk"])
def test_core_matches_oracle_under_cohort_mask(name):
    oracle, core = _pair(name)
    mrng = np.random.default_rng(77)
    for r in range(6):
        mask = mrng.random(U) < 0.6
        oracle.cohort_mask = mask
        core.cohort_mask = mask
        assert_reports_equal(core.step(r), oracle.step(r), f"{name} r{r}")


def test_core_checkpoint_resume():
    oracle, core = _pair("contend_prop")
    for r in range(3):
        oracle.step(r)
        core.step(r)
    _, core2 = _pair("contend_prop")
    core2.load_state_dict(core.state_dict())
    for r in range(3, 6):
        assert_reports_equal(core2.step(r), oracle.step(r), f"resume r{r}")


# --------------------------------------------------- the ordered sums -----
def test_segment_sum_is_bincounts_order():
    """Values spread over 14 decades, so any other association order
    (pairwise, tree, atomics) moves the last bits; an empty group too."""
    rng = np.random.default_rng(0)
    n, groups = 100_000, 8
    x = np.where(rng.random(n) < 0.5, rng.lognormal(0.0, 8.0, n),
                 rng.random(n) * 1e-9)
    g = rng.integers(0, groups, n)
    g[g == 3] = 4
    want = np.bincount(g, weights=x, minlength=groups)
    assert not np.array_equal(
        want, [np.sum(x[g == k]) for k in range(groups)])   # order matters
    got = segment_sum_np_order(torch.from_numpy(x), torch.from_numpy(g),
                               groups)
    assert got.dtype == torch.float64
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("n", [1, 2, 7, 8, 9, 15, 16, 17, 64, 100, 128])
def test_rowsum_is_numpys_pairwise_order(n):
    rng = np.random.default_rng(n)
    a = rng.lognormal(0.0, 6.0, (4096, n))
    cols = [torch.from_numpy(np.ascontiguousarray(a[:, i]))
            for i in range(n)]
    assert np.array_equal(_rowsum_np_order(cols).numpy(), a.sum(axis=1))


# ------------------------------------------------------- the population ----
def test_population_draws_equal_the_reference():
    with reference_wireless():
        from repro.wireless.population import Population as JPopulation
        from repro.wireless.population import kmeans_assign as jkmeans
        for kw in (dict(num_es=2, assignment="round_robin"),
                   dict(num_es=4, assignment="kmeans", data_sigma=0.5)):
            want, got = JPopulation(200, seed=7, **kw), Population(
                200, seed=7, **kw)
            for attr in ("coords", "data_size", "es_assign", "head_slot",
                         "part_count"):
                assert np.array_equal(getattr(got, attr),
                                      getattr(want, attr)), (kw, attr)
            want.rate_scale = got.rate_scale = np.linspace(0.1, 3.0, 200)
            for method in Population.SAMPLING:
                for balanced in (False, True):
                    a = want.sample_cohort(8, method, es_balanced=balanced)
                    b = got.sample_cohort(8, method, es_balanced=balanced)
                    assert np.array_equal(a, b), (kw, method, balanced)
            assert np.array_equal(got.part_count, want.part_count)
        coords = np.random.default_rng(0).random((300, 2))
        la, ca = jkmeans(coords, 5, np.random.default_rng(1))
        lb, cb = kmeans_assign(coords, 5, np.random.default_rng(1))
        assert np.array_equal(la, lb) and np.array_equal(ca, cb)


def test_population_mode_end_to_end_and_resume():
    """A 64-client registry: only cohort members schedule, the core and
    the oracle under the same cohort agree, and a resumed scheduler
    continues bit for bit, cohorts included."""
    wc = WirelessConfig(model="rayleigh", es_uplink_mbps=12.0,
                        contention="proportional", **BASE)
    comm = comm_for_cnn(CNN_CFG, dataset_size=400, batch_size=16)

    def build(pop):
        return make_cohort_scheduler(wc, 64, comm, 2, population=pop,
                                     cohort_size=8, sampling="pareto",
                                     es_balanced=True, core_device="cpu")

    def registry():
        return Population(64, num_es=2, seed=3, assignment="kmeans",
                          data_sigma=0.5)

    pop = registry()
    s = build(pop)
    oracle = make_scheduler(wc, 64, comm, 2, es_assign=pop.es_assign)
    for r in range(4):
        rep = s.step(r)
        oracle.cohort_mask = s.cohort_mask
        assert_reports_equal(rep, oracle.step(r), f"pop r{r}")
        assert set(np.flatnonzero(rep.scheduled)) <= set(s.last_cohort)
        view = cohort_report(rep, s.last_cohort)
        assert view.mask.shape == (8,)
        assert np.array_equal(view.scheduled, rep.scheduled[s.last_cohort])
    assert pop.part_count.sum() == 32 and pop.part_count.max() <= 1
    s2 = build(registry())
    s2.load_state_dict(s.state_dict())
    for r in range(4, 7):
        assert_reports_equal(s.step(r), s2.step(r), f"pop resume r{r}")
        assert np.array_equal(s.last_cohort, s2.last_cohort)


def test_cohort_scheduler_rejects_bad_population():
    wc = WirelessConfig(model="rayleigh", **BASE)
    comm = comm_for_cnn(CNN_CFG, dataset_size=400, batch_size=16)
    with pytest.raises(ValueError):        # N != U
        make_cohort_scheduler(wc, 8, comm, 2, population=Population(64),
                              cohort_size=8, core_device="cpu")
    with pytest.raises(ValueError):        # missing cohort_size
        make_cohort_scheduler(wc, 64, comm, 2, population=Population(64),
                              core_device="cpu")


def test_core_needs_a_card_or_an_explicit_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_scheduler("rayleigh", cls=CohortScheduler)
