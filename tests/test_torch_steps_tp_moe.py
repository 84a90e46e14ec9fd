"""Port parity for tensor parallelism over "model" in the MoE families
(``repro_torch.models.moe``'s experts split over the dim, ``models.mla``'s
heads) against the reference's ``build_step`` on a (data 2, model 2)
mesh of Auto axes, as ``test_torch_steps_tp.py`` holds the dense
decoders (its ``run_cases`` and checks).

Configs: reduced olmoe-1b-7b and deepseek-v2-236b at 2 layers (deepseek:
the dense first layer, then MLA + MoE with one shared expert), widened
to 8 experts top-2 ("-e8") so each rank holds four experts and the
router's choice is a real one.  Cases: the prefill step, a decode step
(logits and the written cache), the paper-faithful train round held on
its update (olmoe under remat "full", whose recompute reads the group
sizes and issues the "model" group's collectives again; deepseek
without; each rank's experts through the expert loop's one-node
backward), and deepseek's decode at batch 1, whose latent cache is split
by length over "data".

Near-ties: each rank routes every token on a hidden state whose sums ran
in another order than the reference's; a token whose k-th and (k+1)-th
router probabilities lie closer than that difference could change
expert.  The ranks record the smallest such margin of these inputs
(``test_route_margins_are_reported``), and every case holds at 2e-5.

Tolerance as ``test_torch_steps_tp.py``: 2e-5 float32 relative to each
leaf's largest magnitude above 1; bf16 cache slots 2e-2; the update
within 2e-5 of its largest magnitude plus an ulp of the leaf's largest
value for each write of the weights (the 2 local steps and the edge
average, as ``chip_smoke.py``'s ``tp_gemma`` counts them: a weight of
~0.1 moved by ~1e-4 spans ~2.5e4 ulps, and two orders of summation round
it apart by up to one ulp a write).
"""

import numpy as np
import pytest

from test_torch_steps_tp import (_check_train, check_decode, port_cases,
                                 run_cases)

ARCHS = ("olmoe-1b-7b-e8", "deepseek-v2-236b-e8")
SHAPES = {"prefill": ("p", 32, 4, "prefill"),
          "decode": ("d", 16, 4, "decode"),
          "train": ("t", 32, 8, "train"),
          "decode_b1": ("d1", 128, 1, "decode")}
INDEX = {"decode": 9, "decode_b1": 100}
ONLY = {"decode_b1": ("deepseek-v2-236b-e8",)}
TRAIN_KW = {"olmoe-1b-7b-e8": {}}
# the round writes the weights at each of its 2 local steps and at the
# edge average: an ulp of rounding each (chip_smoke's tp_gemma's count)
WRITES = 3


def _rank(rank, world, dev, ref_path):
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import moe
    with np.load(ref_path) as z:
        flat = dict(z)
    mesh = make_mesh((2, 2), ("data", "model"), device_type="cpu")
    before = moe.grouped_backwards
    out = port_cases(mesh, flat, ARCHS, SHAPES, ONLY, TRAIN_KW, INDEX)
    grouped = moe.grouped_backwards - before
    return {**(out if rank == 0 else {"margins": out["margins"]}),
            "grouped_backwards": grouped}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return run_cases(tmp_path_factory, _rank, "steps_tp_moe", ARCHS, SHAPES,
                     INDEX, TRAIN_KW, ONLY)


def _cases(kind):
    return [a for a in ARCHS if a in ONLY.get(kind, ARCHS)]


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_logits(runs, arch):
    from test_torch_steps_tp import _close
    ref, ranks = runs
    _close(ranks[0][f"{arch}/prefill"]["logits"],
           ref[f"{arch}/prefill/out/logits"], arch)


@pytest.mark.parametrize("kind,arch", [(k, a) for k in ("decode",
                                                       "decode_b1")
                                       for a in _cases(k)])
def test_decode_logits_and_cache(runs, kind, arch):
    ref, ranks = runs
    check_decode(ref, ranks[0][f"{arch}/{kind}"], arch, kind)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_round(runs, arch):
    ref, ranks = runs
    _check_train(ref, ranks[0][f"{arch}/train"], arch, "train",
                 writes=WRITES)


def test_route_margins_are_reported(runs):
    """Every rank routed every call with a margin above zero (a tie
    would make the choice of expert depend on the order of sums); the
    smallest margin stands in the assertion's message and in CHANGES.md
    (float32 here: ulps are ~1e-7)."""
    _, ranks = runs
    for r in ranks:
        assert set(r["margins"]) == set(ARCHS)
        for arch, m in r["margins"].items():
            assert m > 0, (arch, m)
    print({a: m for a, m in ranks[0]["margins"].items()})


def test_train_rounds_take_the_grouped_backward(runs):
    """Each rank's experts (four of eight) went through the expert loop's
    one-node backward once a MoE layer a local step: the train rounds'
    2 local steps x (olmoe's 2 MoE layers + deepseek's 1 after its dense
    first layer), remat's recompute (olmoe) adding none; the prefill and
    decode steps none."""
    _, ranks = runs
    assert [r["grouped_backwards"] for r in ranks] == [2 * (2 + 1)] * 4
