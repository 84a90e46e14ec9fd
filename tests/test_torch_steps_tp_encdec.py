"""Port parity for tensor parallelism over "model" in the
encoder-decoder (``repro_torch.models.encdec``), and for the
shared-server step's ``fsdp_tp`` layout beyond the dense decoders,
against the reference's ``build_step`` on a (data 2, model 2) mesh of
Auto axes, as ``test_torch_steps_tp.py`` holds the dense decoders (its
``run_cases`` and checks; gemma3-12b's shared-server step under
``fsdp_tp`` is held there).

Configs: reduced seamless-m4t-medium (2 + 2 layers, 32 source frames;
the encoder's, the decoder's self- and cross-attention by heads, the
MLPs by width, the embedding and head by vocabulary, ``src_proj`` whole)
and reduced olmoe-1b-7b widened to 8 experts top-2 ("-e8").  Cases:
seamless's prefill step, a decode step (logits and both caches), decode
at batch 1 (the self and the cross cache split by length over "data"),
the paper-faithful train round held on its update; and the shared-server
step for seamless and olmoe (two clients, one a "data" rank): the body
and head laid out by ``fsdp_tp`` (their "embed" dims over "data"),
gathered at the step's start and their gradients reduce-scattered back,
the client block stacked over "data" and whole over "model", with the
bundle's params and batch specs equal to the reference's leaf for leaf.

Tolerance as ``test_torch_steps_tp.py``: 2e-5 float32 relative to each
leaf's largest magnitude above 1; bf16 cache slots 2e-2; the update
within 2e-5 of its largest magnitude plus an ulp of the leaf's largest
value for each write of the weights (the round's 2 local steps and its
edge average; the shared-server step's one update).  The cross
attention's k bias, whose exact gradient is 0, is held as rounding noise
(``_check_train``'s ``zero_grad``).
"""

import numpy as np
import pytest

from test_torch_steps_tp import (_check_train, _close, check_decode,
                                 check_shared_server_specs, port_cases,
                                 run_cases)

ARCHS = ("seamless-m4t-medium", "olmoe-1b-7b-e8")
SHAPES = {"prefill": ("p", 32, 4, "prefill"),
          "decode": ("d", 16, 4, "decode"),
          "train": ("t", 32, 8, "train"),
          "decode_b1": ("d1", 128, 1, "decode"),
          "shared_server": ("t", 32, 8, "train")}
INDEX = {"decode": 9, "decode_b1": 100}
ONLY = {kind: ("seamless-m4t-medium",) for kind in ("prefill", "decode",
                                                    "train", "decode_b1")}
TRAIN_KW = {}
WRITES = {"train": 3, "shared_server": 1}
# the cross-attention's k bias (its keys take no rotation) adds q.b to
# every logit of a query, which the softmax cancels: its exact gradient
# is 0 and both sides' updates are rounding noise (~1e-12), held under
# TOL of the median leaf's update
ZERO_GRAD = ("cross/k/b",)


def _rank(rank, world, dev, ref_path):
    from repro_torch.launch.mesh import make_mesh
    with np.load(ref_path) as z:
        flat = dict(z)
    mesh = make_mesh((2, 2), ("data", "model"), device_type="cpu")
    out = port_cases(mesh, flat, ARCHS, SHAPES, ONLY, TRAIN_KW, INDEX)
    return out if rank == 0 else None


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return run_cases(tmp_path_factory, _rank, "steps_tp_encdec", ARCHS,
                     SHAPES, INDEX, TRAIN_KW, ONLY)


def test_prefill_logits(runs):
    ref, ranks = runs
    arch = "seamless-m4t-medium"
    _close(ranks[0][f"{arch}/prefill"]["logits"],
           ref[f"{arch}/prefill/out/logits"], arch)


@pytest.mark.parametrize("kind", ["decode", "decode_b1"])
def test_decode_logits_and_caches(runs, kind):
    ref, ranks = runs
    arch = "seamless-m4t-medium"
    check_decode(ref, ranks[0][f"{arch}/{kind}"], arch, kind)


@pytest.mark.parametrize("kind,arch", [("train", "seamless-m4t-medium"),
                                       ("shared_server",
                                        "seamless-m4t-medium"),
                                       ("shared_server", "olmoe-1b-7b-e8")])
def test_train_steps(runs, kind, arch):
    ref, ranks = runs
    _check_train(ref, ranks[0][f"{arch}/{kind}"], arch, kind,
                 writes=WRITES[kind], zero_grad=ZERO_GRAD)


@pytest.mark.parametrize("arch", ARCHS)
def test_shared_server_specs_match_the_reference(runs, arch):
    ref, ranks = runs
    check_shared_server_specs(ref, ranks[0][f"{arch}/shared_server"], arch)
