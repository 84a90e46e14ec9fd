"""Port parity for tensor parallelism over "model" in the recurrent
families (``repro_torch.models.rglru``'s width split, ``models.xlstm``'s
mLSTM and sLSTM) against the reference's ``build_step`` on a (data 2,
model 2) mesh of Auto axes, as ``test_torch_steps_tp.py`` holds the
dense decoders (its ``run_cases`` and checks).

Configs: reduced recurrentgemma-2b at 3 layers ("-l3": RG-LRU, RG-LRU,
local attention; its one kv head held whole, its query heads split),
reduced xlstm-350m (mLSTM, sLSTM; 2 heads, one a rank: K3 and the sLSTM
cell on each rank's heads) and the same with one head ("-h1": the heads
do not divide the dim, so the q/k/v sums are taken whole and every rank
runs every head; the sLSTM's column block is half a head's gates).
Cases: the prefill step, a decode step (logits and the written states),
the paper-faithful train round held on its update (recurrentgemma under
remat "full", the xLSTMs without), and decode at batch 1 for
recurrentgemma and xlstm, whose states the rules split over "data" (the
RG-LRU's width, the xLSTM's heads) besides "model" (the mLSTM carry's
rows): the step gathers them whole and writes each rank's block back.

Tolerance as ``test_torch_steps_tp.py``: 2e-5 float32 relative to each
leaf's largest magnitude above 1 (the recurrent states included); bf16
cache slots 2e-2; the update within 2e-5 of its largest magnitude plus
an ulp of the leaf's largest value for each write of the weights (2
local steps and the edge average).
"""

import numpy as np
import pytest

from test_torch_steps_tp import (_check_train, _close, check_decode,
                                 port_cases, run_cases)

ARCHS = ("recurrentgemma-2b-l3", "xlstm-350m", "xlstm-350m-h1")
SHAPES = {"prefill": ("p", 32, 4, "prefill"),
          "decode": ("d", 16, 4, "decode"),
          "train": ("t", 32, 8, "train"),
          "decode_b1": ("d1", 128, 1, "decode")}
INDEX = {"decode": 9, "decode_b1": 100}
ONLY = {"decode_b1": ("recurrentgemma-2b-l3", "xlstm-350m")}
TRAIN_KW = {"recurrentgemma-2b-l3": {}}
WRITES = 3      # an ulp a write of the weights: 2 local steps, the average


def _rank(rank, world, dev, ref_path):
    from repro_torch.launch.mesh import make_mesh
    with np.load(ref_path) as z:
        flat = dict(z)
    mesh = make_mesh((2, 2), ("data", "model"), device_type="cpu")
    out = port_cases(mesh, flat, ARCHS, SHAPES, ONLY, TRAIN_KW, INDEX)
    return out if rank == 0 else None


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return run_cases(tmp_path_factory, _rank, "steps_tp_recurrent", ARCHS,
                     SHAPES, INDEX, TRAIN_KW, ONLY)


def _cases(kind):
    return [a for a in ARCHS if a in ONLY.get(kind, ARCHS)]


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_logits(runs, arch):
    ref, ranks = runs
    _close(ranks[0][f"{arch}/prefill"]["logits"],
           ref[f"{arch}/prefill/out/logits"], arch)


@pytest.mark.parametrize("kind,arch", [(k, a) for k in ("decode",
                                                       "decode_b1")
                                       for a in _cases(k)])
def test_decode_logits_and_states(runs, kind, arch):
    ref, ranks = runs
    check_decode(ref, ranks[0][f"{arch}/{kind}"], arch, kind)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_round(runs, arch):
    ref, ranks = runs
    _check_train(ref, ranks[0][f"{arch}/train"], arch, "train",
                 writes=WRITES)
