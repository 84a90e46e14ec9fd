"""Dry run (``repro.launch.dryrun``): trace one rank's step of every
(architecture x input shape) on the production meshes over a fake
process group, and record its roofline terms.

    PYTHONPATH=src python -m repro_torch.launch.dryrun            # everything
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma3-12b \\
        --shape train_4k --mesh single --train-mode shared_server

Results land in experiments/dryrun_torch/<arch>__<shape>__<mesh>[__mode]
.json (the reference's names, in a directory of the port's own).

Where the reference lowers and compiles on 256 (or 512) fake XLA
devices, the port opens a fake process group of that many ranks
(``torch.testing._internal.distributed.fake_pg``), builds the mesh over
it, and runs rank 0's step once under ``FakeTensorMode``: tensors with
shapes, dtypes and devices and no data (CUDA ones when a card is
present, CPU ones otherwise), collectives that return at once, and the
kernels' fake registrations (``hopper.dispatch``) in place of launches.
Around it ``FlopCounterMode`` counts the FLOPs, a
``roofline.CollectiveRecorder`` every collective by kind and mesh dim,
and ``MemTracker`` the peak memory.  The terms themselves are the
analytic model's, with ``attn_impl="flash"`` (K2 skips the blocks above
the diagonal and outside the window).

``run_one``'s ``reduced`` and ``shape`` take an arch's ``reduced()``
config and a small shape (the tests').  Every arch traces at a "model"
dim above 1; ``--keep-going`` collects failures as the reference
collects its own.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time
import traceback

from repro_torch.configs.registry import ARCHS, get_arch, supports_shape
from repro_torch.configs.shapes import SHAPES
from repro_torch.launch import roofline as rf

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "experiments", "dryrun_torch")

MESHES = {"single": ((16, 16), ("data", "model")),
          "multipod": ((2, 16, 16), ("pod", "data", "model")),
          "alt32x8": ((32, 8), ("data", "model"))}


def trace_device() -> str:
    """Fake tensors on the card when there is one, else on the CPU."""
    import torch
    return "cuda" if torch.cuda.is_available() else "cpu"


@contextlib.contextmanager
def fake_world(world_size: int):
    """A fake default process group of ``world_size`` ranks (this
    process is rank 0), destroyed on exit."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a process group is already open")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _fake_args(bundle, mesh, device):
    """Rank 0's block of each abstract input, as fake tensors on
    ``device`` (call under ``FakeTensorMode``); the decode index is the
    cache's last position."""
    import torch
    from repro_torch.sharding.rules import local_shape
    from repro_torch.utils.tree import tree_map

    def one(meta, spec):
        return torch.empty(local_shape(tuple(meta.shape), spec, mesh),
                           dtype=meta.dtype, device=device)

    args = []
    for i, (arg, spec) in enumerate(zip(bundle.args, bundle.specs)):
        if bundle.kind == "decode" and i == 3:
            args.append(bundle.meta["cache_len"] - 1)
        else:
            args.append(tree_map(one, arg, spec))
    return tuple(args)


def trace_step(bundle, mesh, device: str) -> dict:
    """Rank 0's step once under ``FakeTensorMode``: its FLOPs, its
    collectives and its peak bytes, and the seconds the trace took."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed._tools.mem_tracker import MemTracker
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.utils.tree import tree_leaves

    t0 = time.time()
    with FakeTensorMode():
        args = _fake_args(bundle, mesh, device)
        tensors = [t for a in args if not isinstance(a, int)
                   for t in tree_leaves(a)]
        mem = MemTracker()
        mem.track_external(*tensors)
        with mem, FlopCounterMode(display=False) as flops, \
                rf.CollectiveRecorder(mesh) as coll:
            bundle.fn(*args)
        peak = mem.get_tracker_snapshot("peak")
    by_device = {str(d): int(v.get("Total", 0)) if isinstance(v, dict)
                 else int(v) for d, v in peak.items()}
    return {"flops": float(flops.get_total_flops()),
            "collectives": coll.record,
            "peak_bytes": float(max(by_device.values(), default=0)),
            "peak_by_device": by_device, "trace_s": time.time() - t0}


def run_one(arch: str, shape_name: str, mesh_name: str, *,
            train_mode: str = "paper_faithful",
            serve_param_mode: str = "fsdp_tp", agg_dtype: str = "float32",
            remat: bool = True, remat_policy: str = "full",
            local_steps: int | None = None, reduced: bool = False,
            shape=None, out_dir: str = OUT_DIR,
            verbose: bool = True) -> dict:
    """Trace one combination over a fake group of the mesh's size and
    write its record.  ``shape`` overrides the named shape (the tests'
    small ones)."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.launch.mesh import make_mesh, num_chips
    from repro_torch.launch.steps import build_step

    cfg = get_arch(arch)
    if reduced:
        cfg = cfg.reduced()
    shape = shape or SHAPES[shape_name]
    dims, names = MESHES[mesh_name]
    tcfg = None
    if (agg_dtype != "float32" or not remat or local_steps is not None
            or remat_policy != "full"):
        tcfg = TrainConfig(agg_dtype=agg_dtype, remat=remat,
                           remat_policy=remat_policy,
                           local_steps_in_step=local_steps or 2)
    device = trace_device()
    chips = 1
    for d in dims:
        chips *= d
    with fake_world(chips):
        mesh = make_mesh(dims, names, device_type="cpu")
        t0 = time.time()
        bundle = build_step(cfg, shape, mesh, train_mode=train_mode,
                            serve_param_mode=serve_param_mode, tcfg=tcfg)
        build_s = time.time() - t0
        traced = trace_step(bundle, mesh, device)
        assert num_chips(mesh) == chips
    roof = rf.analyze(traced, arch=arch, shape=shape, mesh_name=mesh_name,
                      chips=chips, kind=shape.kind, cfg=cfg,
                      mesh_shape=dict(zip(names, dims)), mode=train_mode,
                      attn_impl="flash", param_mode=serve_param_mode,
                      agg_dtype_bytes=(2 if agg_dtype == "bfloat16" else 4),
                      tcfg=tcfg)
    rec = roof.to_dict()
    rec.update({"train_mode": train_mode if shape.kind == "train" else None,
                "step_meta": bundle.meta, "build_s": round(build_s, 3),
                "trace_s": round(traced["trace_s"], 3),
                "trace_device": device, "reduced": reduced,
                "memory_analysis": f"MemTracker peak by device: "
                                   f"{traced['peak_by_device']}"})
    os.makedirs(out_dir, exist_ok=True)
    suffix = f"__{train_mode}" if (shape.kind == "train"
                                   and train_mode != "paper_faithful") else ""
    if shape.kind in ("decode", "prefill") and serve_param_mode != "fsdp_tp":
        suffix += f"__{serve_param_mode}"
    if shape.kind == "train" and agg_dtype != "float32":
        suffix += f"__agg{agg_dtype}"
    if shape.kind == "train" and not remat:
        suffix += "__noremat"
    if shape.kind == "train" and remat_policy != "full":
        suffix += f"__remat_{remat_policy}"
    if shape.kind == "train" and local_steps is not None:
        suffix += f"__k{local_steps}"
    fname = os.path.join(out_dir,
                         f"{arch}__{shape.name}__{mesh_name}{suffix}.json")
    with open(fname, "w") as f:
        json.dump(rec, f, indent=1)
    if verbose:
        c = roof.coll_detail
        print(f"[dryrun] {arch:24s} {shape.name:12s} {mesh_name:8s} "
              f"ok chips={chips} "
              f"compute={roof.compute_s:.3e}s memory={roof.memory_s:.3e}s "
              f"collective={roof.collective_s:.3e}s dominant={roof.dominant} "
              f"(build {build_s:.1f}s trace {traced['trace_s']:.1f}s on "
              f"fake {device})", flush=True)
        print(f"  analytic: flops/chip={roof.flops:.3e} bytes/chip="
              f"{roof.hbm_bytes:.3e} coll_bytes/chip={roof.coll_bytes:.3e} "
              f"useful_flops_ratio={roof.useful_flops_ratio:.3f}", flush=True)
        print(f"  traced: flops={roof.traced_flops:.3e} "
              f"(x{roof.traced_flops_ratio:.3f} analytic) "
              f"coll={roof.traced_coll_bytes:.3e} peak="
              f"{roof.peak_memory_bytes:.3e} counts={c.get('counts')} "
              f"by_dim={ {d: r['counts'] for d, r in c['by_dim'].items()} }",
              flush=True)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, help="architecture id (default all)")
    ap.add_argument("--shape", default=None, help="input shape (default all)")
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multipod", "both", "alt32x8"])
    ap.add_argument("--train-mode", default="paper_faithful",
                    choices=["paper_faithful", "shared_server"])
    ap.add_argument("--serve-params", default="fsdp_tp",
                    choices=["fsdp_tp", "tp"],
                    help="decode weight residency: fsdp (all-gather/step) "
                         "or tp-resident")
    ap.add_argument("--agg-dtype", default="float32",
                    choices=["float32", "bfloat16"],
                    help="hierarchical aggregation psum dtype")
    ap.add_argument("--no-remat", action="store_true",
                    help="disable per-block activation checkpointing")
    ap.add_argument("--remat-policy", default="full",
                    choices=["full", "dots"],
                    help="checkpoint policy: full recompute vs save-dots")
    ap.add_argument("--local-steps", type=int, default=None,
                    help="kappa0 local steps fused per round call")
    ap.add_argument("--out-dir", default=OUT_DIR)
    ap.add_argument("--keep-going", action="store_true",
                    help="continue past failures (collect all errors)")
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else list(ARCHS)
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = ["single", "multipod"] if args.mesh == "both" else [args.mesh]

    failures = []
    n_ok = n_skip = 0
    for mesh_name in meshes:
        for arch in archs:
            for shape_name in shapes:
                if not supports_shape(arch, shape_name):
                    print(f"[dryrun] {arch:24s} {shape_name:12s} "
                          f"{mesh_name:8s} SKIP (long-context requires "
                          f"sub-quadratic mixing)", flush=True)
                    n_skip += 1
                    continue
                try:
                    run_one(arch, shape_name, mesh_name,
                            train_mode=args.train_mode,
                            serve_param_mode=args.serve_params,
                            agg_dtype=args.agg_dtype,
                            remat=not args.no_remat,
                            remat_policy=args.remat_policy,
                            local_steps=args.local_steps,
                            out_dir=args.out_dir)
                    n_ok += 1
                except Exception as e:
                    failures.append((arch, shape_name, mesh_name, repr(e)))
                    print(f"[dryrun] {arch} {shape_name} {mesh_name} FAILED: "
                          f"{e}", flush=True)
                    if not args.keep_going:
                        traceback.print_exc()
                        sys.exit(1)
    print(f"[dryrun] done: {n_ok} ok, {n_skip} skipped, {len(failures)} "
          f"failed", flush=True)
    if failures:
        for f in failures:
            print("  FAIL:", *f)
        sys.exit(1)


if __name__ == "__main__":
    main()
