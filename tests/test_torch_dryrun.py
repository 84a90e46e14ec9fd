"""The port's dry run (``repro_torch.launch.dryrun``) on a fake process
group of 8 ranks, in a subprocess: reduced gemma3-12b on the (2, 2, 2)
("pod", "data", "model") mesh at the reference's debug shapes
(``tests/test_dryrun_debug.py``: train 128 x 16, prefill 128 x 8, decode
128 x 8), traced on fake CPU tensors; olmoe-1b-7b (the MoE) and
recurrentgemma-2b (the RG-LRU) likewise at model 2, and on the (2, 4, 1)
mesh; olmoe's train step once more with its expert loop's backward left
to autograd slice by slice.

Checked: each record carries the reference's keys (its ``Roofline.
to_dict()``'s, with ``traced_*`` in place of ``hlo_*``, and the run's
``train_mode``, ``step_meta`` and ``memory_analysis``); the train
record's "model"-group all-reduces are as many as reckoned below, and its
"data" and "pod" groups carry the edge and global steps; nothing is
written outside ``--out-dir``.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
SHAPES = {"train": ("t", 128, 16, "train"), "prefill": ("p", 128, 8,
                                                        "prefill"),
          "decode": ("d", 128, 8, "decode")}
# the small meshes this file traces (tests/test_dryrun_debug.py's), added
# to the dry run's MESHES inside the subprocess
DEBUG_MESHES = {"debug_multipod": ((2, 2, 2), ("pod", "data", "model")),
                "debug_multipod_tp1": ((2, 4, 1), ("pod", "data", "model"))}

_SCRIPT = r"""
import json, sys, tempfile
import torch
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun
from repro_torch.models import moe
from repro_torch.models.layers import activation
out_dir, shapes, meshes = sys.argv[1], *map(json.loads, sys.argv[2:4])
dryrun.MESHES.update(meshes)
res = {}
for arch in ["gemma3-12b", "olmoe-1b-7b", "recurrentgemma-2b"]:
    for mesh in meshes:
        if arch == "gemma3-12b" and mesh == "debug_multipod_tp1":
            continue
        for kind, sh in shapes.items():
            key = f"{arch}/{mesh}/{kind}"
            before = moe.grouped_backwards
            try:
                rec = dryrun.run_one(arch, sh[0], mesh, reduced=True,
                                     shape=ShapeConfig(*sh), out_dir=out_dir,
                                     verbose=False)
                res[key] = {"ok": True, "rec": rec,
                            "grouped": moe.grouped_backwards - before}
            except NotImplementedError as e:
                res[key] = {"ok": False, "error": str(e)}
# the MoE's train step again with the expert loop left to autograd slice
# by slice (the shared forward body under autograd)
moe._GroupedExperts.apply = lambda xs, wg, wu, wd, sizes, act: torch.cat(
    moe._expert_loop(xs, wg, wu, wd, sizes, activation(act)))
res["olmoe-1b-7b/debug_multipod/train_slice_loop"] = {
    "ok": True, "rec": dryrun.run_one(
        "olmoe-1b-7b", "t", "debug_multipod", reduced=True,
        shape=ShapeConfig(*shapes["train"]), out_dir=tempfile.mkdtemp(),
        verbose=False)}
res["gemma3-12b/debug_multipod/train_shared_server"] = {
    "ok": True, "rec": dryrun.run_one(
        "gemma3-12b", "t", "debug_multipod", reduced=True,
        shape=ShapeConfig(*shapes["train"]), train_mode="shared_server",
        out_dir=out_dir, verbose=False)}
print(json.dumps(res))
"""


@pytest.fixture(scope="module")
def dryrun(tmp_path_factory):
    work = tmp_path_factory.mktemp("dryrun_cwd")
    out = tmp_path_factory.mktemp("dryrun_out")
    home = tmp_path_factory.mktemp("dryrun_home")
    repo_out = ROOT / "experiments" / "dryrun_torch"
    before = sorted(repo_out.iterdir()) if repo_out.exists() else None
    run = subprocess.run(
        [sys.executable, "-c", _SCRIPT, str(out), json.dumps(SHAPES),
         json.dumps(DEBUG_MESHES)],
        capture_output=True, text=True, timeout=600, cwd=work,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src"),
             "HOME": str(home), "TMPDIR": str(home),
             "OMP_NUM_THREADS": "2"})
    assert run.returncode == 0, run.stderr[-3000:]
    after = sorted(repo_out.iterdir()) if repo_out.exists() else None
    return (json.loads(run.stdout.strip().splitlines()[-1]), out, work,
            home, before == after)


def _reference_keys():
    from repro.launch.roofline import Roofline
    keys = set(Roofline(arch="a", shape="s", mesh="m", chips=1, flops=1.0,
                        hbm_bytes=1.0, coll_bytes=1.0).to_dict())
    keys = {k for k in keys if not k.startswith("hlo_")}
    return keys | {"train_mode", "step_meta", "memory_analysis",
                   "traced_flops_per_chip",
                   "traced_collective_bytes_per_chip"}


@pytest.mark.parametrize("kind", sorted(SHAPES))
def test_gemma_records_carry_the_reference_keys(dryrun, kind):
    res, out, *_ = dryrun
    row = res[f"gemma3-12b/debug_multipod/{kind}"]
    assert row["ok"], row
    rec = row["rec"]
    assert _reference_keys() <= set(rec)
    assert rec["chips"] == 8 and rec["mesh"] == "debug_multipod"
    assert rec["traced_flops_per_chip"] > 0 and rec["flops_per_chip"] > 0
    assert rec["peak_memory_bytes"] > 0
    saved = json.loads((out / f"gemma3-12b__{SHAPES[kind][0]}__"
                               f"debug_multipod.json").read_text())
    assert saved == json.loads(json.dumps(rec))


def _model_all_reduces(cfg, seq: int, local_steps: int) -> int:
    """The "model" group's all-reduces of one client's round under remat
    "full" with the head split by vocabulary, the heads and width split
    and the kv heads dividing the dim.  A local step's forward: the
    embedding's 1, each layer's 2 (o, down) and each 512-token loss
    chunk's 2 (the max and the sums).  Its backward: each layer's
    recompute issues o's again (non-reentrant checkpointing stops the
    recompute at the last saved tensor, before down's), the input of
    attention and of the MLP and each whole leaf of a split block (the q
    and k norms) sum their gradients, each loss chunk's recompute issues
    its 2 again, and the hidden state's gradient 1."""
    chunks = seq // 512 if seq % 512 == 0 else 1
    whole = 2 if cfg.qk_norm else 0
    per_layer = 2 + 1 + 2 + whole
    return local_steps * (1 + cfg.num_layers * per_layer + 4 * chunks + 1)


def test_train_record_collectives(dryrun):
    from repro_torch.configs.registry import get_arch
    from repro_torch.core.phsfl import abstract_params
    from repro_torch.models.registry import build_model
    from repro_torch.utils.tree import tree_leaves
    res, *_ = dryrun
    rec = res["gemma3-12b/debug_multipod/train"]["rec"]
    by_dim = rec["collective_detail"]["by_dim"]
    cfg = get_arch("gemma3-12b").reduced()
    k = rec["step_meta"]["local_steps"]
    assert by_dim["model"]["counts"]["all-reduce"] == _model_all_reduces(
        cfg, SHAPES["train"][1], k)
    leaves = len(tree_leaves(abstract_params(build_model(cfg))))
    # the edge step over "data" and the global one over "pod": one
    # all_reduce a leaf each, then the loss's mean over each client dim
    for dim in ("data", "pod"):
        assert by_dim[dim]["counts"]["all-reduce"] == leaves + 1
    assert rec["collective_detail"]["counts"]["all-reduce"] == sum(
        r["counts"]["all-reduce"] for r in by_dim.values())
    assert rec["traced_collective_bytes_per_chip"] == \
        rec["collective_detail"]["total"]


def test_serving_records_gather_and_reduce(dryrun):
    res, *_ = dryrun
    cfg_layers = 2
    for kind in ("prefill", "decode"):
        by_dim = res[f"gemma3-12b/debug_multipod/{kind}"]["rec"][
            "collective_detail"]["by_dim"]
        # fsdp_tp: the embed-sharded leaves gathered over each client dim
        assert by_dim["data"]["counts"]["all-gather"] > 0
        assert by_dim["pod"]["counts"]["all-gather"] == \
            by_dim["data"]["counts"]["all-gather"]
        # the embedding's reduce and each layer's two
        assert by_dim["model"]["counts"]["all-reduce"] == 1 + 2 * cfg_layers


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "recurrentgemma-2b"])
def test_other_families_trace_at_model_two(dryrun, arch):
    """The MoE and the RG-LRU trace every shape at model 2, reducing over
    the "model" group, and at model 1 with no "model" collective."""
    res, *_ = dryrun
    for kind in SHAPES:
        row = res[f"{arch}/debug_multipod/{kind}"]
        assert row["ok"], row
        rec = row["rec"]
        assert _reference_keys() <= set(rec)
        assert rec["traced_flops_per_chip"] > 0
        assert rec["collective_detail"]["by_dim"]["model"]["counts"][
            "all-reduce"] > 0
        ok = res[f"{arch}/debug_multipod_tp1/{kind}"]
        assert ok["ok"], ok
        assert ok["rec"]["collective_detail"]["by_dim"].get(
            "model", {"counts": {"all-reduce": 0}})["counts"][
                "all-reduce"] == 0


def test_moe_train_trace_takes_the_grouped_backward(dryrun):
    """The MoE's train step on fake tensors (remat "full", the even split
    of the pairs) takes the expert loop's one-node backward once a MoE
    layer a local step, and traces the FLOPs and collectives that the
    slice-by-slice autograd loop traces, at no higher peak; serving steps
    take none."""
    from repro_torch.configs.registry import get_arch
    res, *_ = dryrun
    layers = get_arch("olmoe-1b-7b").reduced().num_layers
    for mesh in DEBUG_MESHES:
        for kind in SHAPES:
            row = res[f"olmoe-1b-7b/{mesh}/{kind}"]
            want = (layers * row["rec"]["step_meta"]["local_steps"]
                    if kind == "train" else 0)
            assert row["grouped"] == want, (mesh, kind)
    rec = res["olmoe-1b-7b/debug_multipod/train"]["rec"]
    plain = res["olmoe-1b-7b/debug_multipod/train_slice_loop"]["rec"]
    assert rec["traced_flops_per_chip"] == plain["traced_flops_per_chip"]
    assert rec["collective_detail"] == plain["collective_detail"]
    assert rec["peak_memory_bytes"] <= plain["peak_memory_bytes"]


def test_shared_server_record(dryrun):
    """The shared-server step at model 2 under the reference's ``fsdp_tp``
    layout: the "model" group's reduces, and over each client dim one
    all_gather a shared leaf split over it (the body and head gathered
    at the step's start), one reduce_scatter a trained one (its
    gradient, back to the rank's block), one all_reduce a shared trained
    leaf held whole over the client dims (its gradient) plus the
    loss's."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.configs.registry import get_arch
    from repro_torch.core.phsfl import abstract_params, build_optimizer
    from repro_torch.core.split import part_masks, split_spec_for
    from repro_torch.models.registry import build_model
    from repro_torch.sharding.rules import AbstractMesh, params_specs
    from repro_torch.utils.tree import tree_leaves
    res, *_ = dryrun
    rec = res["gemma3-12b/debug_multipod/train_shared_server"]["rec"]
    assert rec["train_mode"] == "shared_server"
    assert rec["step_meta"]["mode"] == "shared_server"
    assert _reference_keys() <= set(rec)
    cfg = get_arch("gemma3-12b").reduced()
    model = build_model(cfg)
    shapes = abstract_params(model)
    client = part_masks(shapes, split_spec_for(cfg))["client"]
    _, trained = build_optimizer(model, TrainConfig(shared_server=True),
                                 params=shapes)
    mesh = AbstractMesh(*DEBUG_MESHES["debug_multipod"][::-1])
    specs = params_specs(shapes, model.axes(), mesh, mode="fsdp_tp")
    spec_leaves = []

    def walk(t):
        if isinstance(t, dict):
            for v in t.values():
                walk(v)
        else:
            spec_leaves.append(t)
    walk(specs)
    by_dim = rec["collective_detail"]["by_dim"]
    for dim in ("data", "pod"):
        split = [not c and any(isinstance(e, tuple) and dim in e or e == dim
                               for e in sp)
                 for c, sp in zip(tree_leaves(client), spec_leaves)]
        gathered = sum(split)
        scattered = sum(s and m for s, m in zip(split, tree_leaves(trained)))
        whole = sum(m and not c and not s for c, m, s in zip(
            tree_leaves(client), tree_leaves(trained), split))
        assert gathered > 0 and scattered > 0
        counts = by_dim[dim]["counts"]
        assert counts["all-gather"] == gathered
        assert counts["reduce-scatter"] == scattered
        assert counts["all-reduce"] == whole + 1
    assert by_dim["model"]["counts"]["all-reduce"] > 0


def test_nothing_written_outside_out_dir(dryrun):
    res, out, work, home, repo_unchanged = dryrun
    assert repo_unchanged
    assert list(work.iterdir()) == []
    names = {p.name for p in out.iterdir()}
    want = {f"{key.split('/')[0]}__{SHAPES[key.split('/')[2]][0]}__"
            f"{key.split('/')[1]}.json" for key, row in res.items()
            if row["ok"] and key.split("/")[2] in SHAPES}
    want.add(f"gemma3-12b__{SHAPES['train'][0]}__debug_multipod__"
             f"shared_server.json")
    assert names == want
