"""The launcher's mesh path (``repro_torch.launch.train`` under a process
group): two gloo ranks on the CPU, one client each, through
``make_phsfl_round``.

- Under ``torchrun`` (``python -m torch.distributed.run --nproc_per_node
  2``), ``main`` prints the backend first and then, on rank 0 only, the
  same log records and final JSON as the one-device ``main`` (the round
  losses and personalization numbers are the same floats: each mean adds
  two operands).
- On two spawned ranks (``launch.distributed.spawn``): the state
  checkpoints a mesh run writes equal the one-device run's bit for bit
  (rank 0 gathers the (C, ...) state), a mesh run resumes from a
  one-device run's checkpoint to the same end, the wireless scheduler's
  mask reaches the masked mesh round, and a group whose size is not
  ``--clients`` raises.
"""

import contextlib
import io
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
BASE = ["--device", "cpu", "--rounds", "2", "--clients", "2", "--seq", "16",
        "--local-steps", "1", "--finetune-steps", "2"]
WIRELESS = ["--channel", "rayleigh", "--deadline", "0.3", "--cut-policy",
            "greedy", "--cut-candidates", "1", "2"]
STEP = "ckpt_00000002.npz"


def _with(argv, flag, value):
    i = argv.index(flag)
    return argv[:i + 1] + [value] + argv[i + 2:]


def _main(argv):
    """``main``'s stdout lines, or the error it raised."""
    from repro_torch.launch import train
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            train.main(argv)
    except (ValueError, RuntimeError) as e:
        return f"raised {type(e).__name__}: {e}"
    return buf.getvalue().strip().splitlines()


def _rank_worker(rank, world, dev, runs):
    return [_main(argv) for argv in runs]


def _records(lines):
    """The log records without their wall-clock fields, and the JSON."""
    recs = [json.loads(ln.split(" ", 1)[1]) for ln in lines[:-1]]
    for r in recs:
        r.pop("t", None)
        r.pop("s_per_round", None)
    return recs, json.loads(lines[-1])


@pytest.fixture(scope="module")
def two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def host(tmp_path_factory, two_threads):
    """The one-device runs: plain with a state checkpoint every round, a
    run cut after round 1, and the wireless run."""
    d = tmp_path_factory.mktemp("host")
    return d, {
        "ckpt": _main(BASE + ["--ckpt-dir", str(d / "whole"),
                              "--ckpt-every", "1"]),
        "cut": _main(BASE + ["--ckpt-dir", str(d / "cut"), "--ckpt-every",
                             "1", "--abort-after", "1"]),
        "wireless": _main(BASE + WIRELESS)}


@pytest.fixture(scope="module")
def mesh(host, tmp_path_factory):
    from repro_torch.launch.distributed import spawn
    hd, _ = host
    d = tmp_path_factory.mktemp("mesh")
    runs = [BASE + ["--ckpt-dir", str(d / "whole"), "--ckpt-every", "1"],
            BASE + ["--ckpt-dir", str(hd / "cut"), "--ckpt-every", "1",
                    "--resume"],
            BASE + WIRELESS,
            _with(BASE, "--clients", "4")]
    return d, spawn(_rank_worker, 2, (runs,), threads=2, timeout=300)


def test_torchrun_main_prints_the_one_device_json(host, tmp_path):
    run = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "2", "-m", "repro_torch.launch.train", *BASE],
        capture_output=True, text=True, timeout=300, cwd=tmp_path,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src"),
             "OMP_NUM_THREADS": "2"})
    assert run.returncode == 0, run.stderr[-3000:]
    lines = run.stdout.strip().splitlines()
    assert lines[0] == "[train] mesh backend=gloo world=2 device=cpu"
    got = _records(lines[1:])
    want = _records([ln for ln in host[1]["ckpt"] if "ckpt" not in ln])
    assert got == want


def test_mesh_state_checkpoints_equal_the_one_device_run(host, mesh):
    hd, _ = host
    md, ranks = mesh
    assert ranks[1][0] == []                      # rank 1 prints nothing
    for name in ("state/ckpt_00000001.npz", f"state/{STEP}", STEP):
        with np.load(hd / "whole" / name) as a, \
                np.load(md / "whole" / name) as b:
            assert sorted(a.files) == sorted(b.files)
            for k in a.files:
                assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
                assert a[k].tobytes() == b[k].tobytes(), (name, k)
    assert _records(ranks[0][0][1:]) == _records(host[1]["ckpt"])


def test_mesh_resumes_a_one_device_checkpoint(host, mesh):
    _, ranks = mesh
    lines = ranks[0][1]
    assert '"resumed_from_round": 1.0' in lines[1]
    assert json.loads(lines[-1]) == json.loads(host[1]["ckpt"][-1])


def test_wireless_mask_reaches_the_mesh_round(host, mesh):
    _, ranks = mesh
    got, want = _records(ranks[0][2][1:]), _records(host[1]["wireless"])
    assert got == want
    assert set(want[1]) == {"final_loss", "personalization_gain",
                            "sim_time_s", "energy_left_j_min"}
    assert any(r.get("participants", 2) < 2 for r in want[0])


def test_a_group_of_the_wrong_size_raises(mesh):
    _, ranks = mesh
    for r in ranks:
        assert r[3].startswith("raised ValueError: a process group of 2 "
                               "ranks cannot train 4 clients"), r[3]
