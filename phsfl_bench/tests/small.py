"""Small cells for the CPU tests: a reduced configuration of each family
in the port's form and in the benchmark's, a traffic mix at a size the
CPU holds, and the limits of the real cell of the same kind."""

from __future__ import annotations

import dataclasses

from phsfl_bench import harness

ROUND = {"kind": "phsfl_round", "clients": 4, "edge_servers": 2,
         "kappa0": 2, "micro": 2, "seq": 32, "lr": 4.0}
ENCDEC_ROUND = {**ROUND, "seq": 16, "source_frames": 32}
BANK = {"kind": "head_bank", "clients": 3, "batch": 2, "seq": 32,
        "steps": 3, "lr": 1.0}
# float32 at these sizes: program and reference agree to round-off
TIGHT_ROUND = {"loss": 1e-5, "update1": 1e-4, "change3": 1e-4,
               "head_moved": 0.0}
TIGHT_BANK = {"loss": 1e-5, "change": 1e-4}


def configs(name: str):
    """(the port's ModelConfig, the benchmark's dict) of a reduced
    ``olmoe`` (3 layers, 8 experts top-2) or ``seamless``."""
    from repro_torch.configs.registry import get_arch
    if name == "olmoe":
        prog = get_arch("olmoe-1b-7b").reduced(num_layers=3, max_experts=8)
        prog = dataclasses.replace(prog, moe=dataclasses.replace(
            prog.moe, top_k=2))
        ref = "decoder"
    else:
        prog = get_arch("seamless-m4t-medium").reduced()
        ref = "encdec"
    cfg = dataclasses.asdict(prog)
    cfg["block_pattern"] = list(cfg["block_pattern"])
    cfg.update(reference=ref, arch=prog.name)
    return prog, cfg


def cell(family: str, traffic: dict, limits: dict | None = None):
    prog, cfg = configs(family)
    real = "olmoe4-personalize" if traffic["kind"] == "head_bank" \
        else "olmoe4-phsfl"
    like = harness.load_cell(real)
    limits = limits or (TIGHT_BANK if traffic["kind"] == "head_bank"
                        else TIGHT_ROUND)
    return prog, harness.Cell(f"small-{family}", cfg, dict(traffic), limits,
                              like.end_to_end, like.per_layer)


def run(family: str, traffic: dict, limits=None, seed: int = 2**31 + 11,
        trace: bool = False):
    prog, c = cell(family, traffic, limits)
    return harness.run_cell(c, seed=seed, seconds=0.0, trace=trace,
                            device="cpu", program_cfg=prog)
