"""Run manifest: everything needed to attribute a metrics/trace artifact.

The port's copy of ``repro.telemetry.manifest``, with the torch/CUDA
environment (``torch_info``, under the key ``"torch"``) where the
reference records its array library's; every other key is the
reference's.

A manifest answers "what produced this file?": a stable hash of the run's
config, the seeds, the torch/device environment, the git SHA of the
working tree, and the exact command line.  ``collect_manifest`` gathers it
(every probe is best-effort — a missing git binary or an import-less
environment degrades to ``None``, never an exception), ``write_manifest``
puts it next to the other telemetry outputs.
"""

from __future__ import annotations

import hashlib
import json
import os
import platform
import subprocess
import sys
import time


def config_hash(config) -> str | None:
    """sha256 over a canonical rendering of ``config``.

    Frozen dataclasses (every repo config) have deterministic ``repr``s, so
    two runs share a hash iff they share a config.  Dicts are rendered as
    sorted-keys JSON-ish reprs for the same stability.
    """
    if config is None:
        return None
    if isinstance(config, dict):
        text = json.dumps({k: repr(v) for k, v in config.items()},
                          sort_keys=True)
    else:
        text = repr(config)
    return hashlib.sha256(text.encode()).hexdigest()


def git_sha(cwd: str | None = None) -> str | None:
    try:
        out = subprocess.run(["git", "rev-parse", "HEAD"],
                             cwd=cwd or os.getcwd(), capture_output=True,
                             text=True, timeout=10)
        return out.stdout.strip() or None if out.returncode == 0 else None
    except (OSError, subprocess.SubprocessError):
        return None


def torch_info() -> dict | None:
    """torch's version and CUDA build, and the device a run would use: the
    card when one is visible (its name and the number of cards), else the
    CPU."""
    try:
        import torch
        cuda = torch.cuda.is_available()
        return {"version": torch.__version__,
                "cuda": torch.version.cuda,
                "backend": "cuda" if cuda else "cpu",
                "device_kind": (torch.cuda.get_device_name() if cuda
                                else None),
                "device_count": torch.cuda.device_count() if cuda else 0}
    except Exception:                     # no torch or CUDA: still a run
        return None


def collect_manifest(*, config=None, seeds=None, extra=None) -> dict:
    """One JSON-safe dict describing this run's provenance."""
    man = {
        "config_hash": config_hash(config),
        "config_repr": None if config is None else repr(config),
        "seeds": seeds,
        "git_sha": git_sha(),
        "torch": torch_info(),
        "python": sys.version.split()[0],
        "platform": platform.platform(),
        "argv": list(sys.argv),
        "timestamp": time.strftime("%Y-%m-%dT%H:%M:%S%z"),
    }
    if extra:
        man.update(extra)
    return man


def write_manifest(path: str, manifest: dict) -> str:
    with open(path, "w") as fh:
        json.dump(manifest, fh, indent=1, sort_keys=True, default=repr)
        fh.write("\n")
    return path
