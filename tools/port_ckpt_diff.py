"""Bitwise diff of two of the PyTorch port's flat-npz checkpoints (or
checkpoint directories).

The port's counterpart of ``tools/ckpt_diff.py``: the same contract and
report, with a directory resolved through ``repro_torch.checkpoint``.
The port's resume contract (``FedSim.save``/``restore``,
``repro_torch/launch/train.py --resume``) is BIT-identity: a killed-and-
resumed run must produce byte-for-byte the same checkpoints as an
uninterrupted one.  ``make port-resume-smoke`` drives two such runs and
calls this tool on the results — exit 0 iff every array agrees exactly
(shape, dtype, and raw bytes, so NaN payloads and signed zeros count
too), 1 with a per-key report otherwise.

    python -m tools.port_ckpt_diff runA/state runB/state   # latest steps
    python -m tools.port_ckpt_diff a.npz b.npz
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np


def _resolve(path: str) -> str:
    """A .npz file as-is; a directory resolves to its latest ckpt_*.npz."""
    if os.path.isdir(path):
        sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                        "src"))
        from repro_torch.checkpoint import latest_step
        step = latest_step(path)
        if step is None:
            raise SystemExit(f"port_ckpt_diff: no ckpt_*.npz in {path}")
        return os.path.join(path, f"ckpt_{step:08d}.npz")
    return path


def diff(path_a: str, path_b: str) -> list[str]:
    """Human-readable mismatch lines; empty iff bit-identical."""
    out = []
    with np.load(path_a) as a, np.load(path_b) as b:
        keys_a, keys_b = set(a.files), set(b.files)
        for k in sorted(keys_a - keys_b):
            out.append(f"only in {path_a}: {k}")
        for k in sorted(keys_b - keys_a):
            out.append(f"only in {path_b}: {k}")
        for k in sorted(keys_a & keys_b):
            va, vb = a[k], b[k]
            if va.shape != vb.shape:
                out.append(f"{k}: shape {va.shape} != {vb.shape}")
            elif va.dtype != vb.dtype:
                out.append(f"{k}: dtype {va.dtype} != {vb.dtype}")
            elif va.tobytes() != vb.tobytes():
                n = int(np.sum(np.frombuffer(va.tobytes(), np.uint8)
                               != np.frombuffer(vb.tobytes(), np.uint8)))
                out.append(f"{k}: {n} differing byte(s) of "
                           f"{va.nbytes}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m tools.port_ckpt_diff",
        description="bitwise-compare two of the port's flat-npz "
                    "checkpoints")
    ap.add_argument("a", help="checkpoint file or directory (latest step)")
    ap.add_argument("b", help="checkpoint file or directory (latest step)")
    args = ap.parse_args(argv)
    pa, pb = _resolve(args.a), _resolve(args.b)
    mismatches = diff(pa, pb)
    for line in mismatches:
        print(line)
    if mismatches:
        print(f"port_ckpt_diff: {pa} != {pb} ({len(mismatches)} "
              f"mismatch(es))")
        return 1
    print(f"port_ckpt_diff: {pa} == {pb} (bit-identical)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
