"""The readings that a cell's limits are set from, at the cell's own size:

- ``program``: the program's numbers against the plain reference, as a
  run's check makes them (set-up and check, no window), for each seed;
- ``control``: the reference in bfloat16 against the same reference with
  every matrix product's operands rounded to float8 e4m3 (the precision
  below the configuration's) put in the program's place;
- ``half``: the reference against itself on half of each batch's rows
  (half of the batch left out, the mean taken over the rest).

    python3 phsfl_bench/control.py --workload olmoe4-phsfl \\
        --seeds 11 12 13 --what program control half

Each reading is one JSON line on standard output.  Several seeds run in
one process, so the set-up of the process is paid once.  Needs the card.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))


def readings(cell, seed: int, what: str, device: str = "cuda",
             program_cfg=None) -> dict:
    import torch
    from phsfl_bench import harness
    from phsfl_bench.reference.common import Numerics
    prog = program_cfg or harness.program_config(cell.config)
    run = harness.Run(cell, seed, device, prog, harness.family(cell.config))
    kind = harness.kind_module(cell.kind)
    if what == "program":
        unit = kind.Unit(run)
        unit.release()
        del unit
        got = run.readings
    else:
        got = kind.reference_readings(run, Numerics(fp8=what == "control"),
                                      half=what == "half")
        got.pop("first", None)
        if device == "cuda":
            torch.cuda.empty_cache()
    ref = kind.reference_readings(run, Numerics())
    return kind.compare(got, ref)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--what", nargs="+", default=["program", "control",
                                                   "half"],
                    choices=["program", "control", "half"])
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from phsfl_bench import harness
    harness.set_caches()
    cell = harness.load_cell(args.workload)
    for seed in args.seeds:
        for what in args.what:
            t0 = time.perf_counter()
            nums = readings(cell, seed, what)
            torch.cuda.empty_cache()
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "what": what, "numbers": nums,
                              "seconds": time.perf_counter() - t0}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
