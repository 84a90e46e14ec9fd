"""Run one cell of the benchmark once and print its result line.

    python3 phsfl_bench/run.py --workload olmoe4-phsfl --seed 7 \\
        --seconds 20 --trace 0

(or ``python3 -m phsfl_bench.run ...`` from the checkout's root).  The
last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics,
or with ``--trace 1`` its per-layer metrics), ``device``, with ``--trace
1`` ``breakdown``, and last ``checks``: each number compared with the
plain reference beside its limit.  The same numbers are the last lines
of standard error.  The run fails, and prints no result, without a CUDA
device for each chip the cell asks for, or when JAX or the JAX package
is loaded once the window has closed.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))


def _device_info(torch, chips: int) -> dict:
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips}
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60).stdout.strip()
        print(f"nvidia-smi: {smi}", file=sys.stderr)
    except (OSError, subprocess.SubprocessError) as e:
        print(f"nvidia-smi: not read ({e})", file=sys.stderr)
    return info


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from phsfl_bench import harness
    harness.set_caches()
    bench = harness.manifest()
    cell = harness.load_cell(args.workload, bench)
    chips = next(w["chips"] for w in bench["workloads"]
                 if w["name"] == args.workload)
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"need {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    result = harness.run_cell(cell, seed=args.seed, seconds=args.seconds,
                              trace=bool(args.trace), device="cuda",
                              device_info=_device_info(torch, chips))
    bad = harness.forbidden_modules()
    if bad:
        print(f"modules that must not load were loaded: {bad}",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
