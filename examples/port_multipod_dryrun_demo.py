"""Trace ONE (arch x shape) on the 512-chip multi-pod production mesh and
print its memory/cost/roofline analysis.

    PYTHONPATH=src python examples/port_multipod_dryrun_demo.py \
        [--arch gemma3-12b] [--shape train_4k]

(the PyTorch port's counterpart of ``examples/multipod_dryrun_demo.py``:
it runs ``python -m repro_torch.launch.dryrun`` with the same flags in a
child process, which opens its own fake process group of the mesh's
ranks and traces rank 0's step on fake tensors: CUDA ones where a card
is present, CPU ones elsewhere)
"""

import argparse
import os
import subprocess
import sys

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma3-12b")
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--mesh", default="multipod",
                    choices=["single", "multipod"])
    args = ap.parse_args(argv)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (os.path.normpath(SRC), env.get("PYTHONPATH")) if p)
    return subprocess.call(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         args.arch, "--shape", args.shape, "--mesh", args.mesh], env=env)


if __name__ == "__main__":
    sys.exit(main())
