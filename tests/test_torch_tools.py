"""The tools on the port's output: ``tools/port_ckpt_diff.py`` over the
port's kill-and-resume checkpoints and ``tools/check_trace.py`` over its
``--trace-dir`` directory, as the Makefile's ``port-resume-smoke`` and
``port-trace-smoke`` run them, here on the CPU with the Makefile's own
``RESUME_ARGS``."""

import contextlib
import io
import shutil
import numpy as np
import pytest
import torch

from chip_smoke import _resume_args
from repro_torch.launch.train import main as train_main
from tools import check_trace, ckpt_diff, port_ckpt_diff

STEP = "ckpt_00000002.npz"


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's side on one intra-op thread.  The tier-1 run puts six
    test processes on eight cores; torch's default of a thread a core
    then spends most of a small op waiting on the others (and starves the
    reference's side): this file's launcher runs took 30x their time alone
    there.  The tolerances and assertions are the same at any thread
    count."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _train(*extra):
    with contextlib.redirect_stdout(io.StringIO()), \
            contextlib.redirect_stderr(io.StringIO()):
        return train_main([*_resume_args(), "--device", "cpu", *extra])


@pytest.fixture(scope="module")
def resume_runs(tmp_path_factory):
    """make port-resume-smoke's three runs: whole, killed after round 1,
    resumed."""
    assert {"--ckpt-every", "--rounds"} <= set(_resume_args())
    d = tmp_path_factory.mktemp("port_resume_smoke")
    whole = _train("--ckpt-dir", str(d / "full"))
    cut = _train("--ckpt-dir", str(d / "killed"), "--abort-after", "1")
    resumed = _train("--ckpt-dir", str(d / "killed"), "--resume")
    assert whole.aborted_after is None and cut.aborted_after == 1
    assert resumed.start_round == 1
    return d


@pytest.fixture(scope="module")
def trace_run(tmp_path_factory):
    """make port-trace-smoke's run."""
    d = tmp_path_factory.mktemp("port_trace_smoke") / "trace"
    _train("--trace-dir", str(d))
    return d


def _quiet(fn, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fn(argv)
    return rc, buf.getvalue()


def test_resumed_state_is_bit_identical(resume_runs):
    d = resume_runs
    rc, out = _quiet(port_ckpt_diff.main,
                     [str(d / "full" / "state"), str(d / "killed" / "state")])
    assert rc == 0, out
    assert "bit-identical" in out and STEP in out
    # the files as well as the directories; the final params too
    for sub in ("state/" + STEP, STEP):
        rc, out = _quiet(port_ckpt_diff.main,
                         [str(d / "full" / sub), str(d / "killed" / sub)])
        assert rc == 0, out


def test_one_flipped_byte_is_found(resume_runs, tmp_path):
    d = resume_runs
    with np.load(d / "killed" / "state" / STEP) as f:
        arrays = {k: f[k].copy() for k in f.files}
    key = max(sorted(arrays), key=lambda k: arrays[k].nbytes)
    raw = arrays[key].view(np.uint8).reshape(-1)
    raw[raw.size // 2] ^= 0x01
    np.savez(tmp_path / STEP, **arrays)
    rc, out = _quiet(port_ckpt_diff.main,
                     [str(d / "full" / "state"), str(tmp_path)])
    assert rc == 1
    assert f"{key}: 1 differing byte(s)" in out
    assert port_ckpt_diff.diff(str(d / "full" / "state" / STEP),
                               str(tmp_path / STEP)) == \
        ckpt_diff.diff(str(d / "full" / "state" / STEP),
                       str(tmp_path / STEP))


def test_missing_key_and_empty_directory(resume_runs, tmp_path):
    d = resume_runs
    with np.load(d / "full" / "state" / STEP) as f:
        arrays = {k: f[k] for k in f.files}
    dropped = sorted(arrays)[0]
    del arrays[dropped]
    np.savez(tmp_path / STEP, **arrays)
    rc, out = _quiet(port_ckpt_diff.main,
                     [str(d / "full" / "state" / STEP),
                      str(tmp_path / STEP)])
    assert rc == 1 and f"only in {d / 'full' / 'state' / STEP}: " \
        f"{dropped}" in out
    (tmp_path / "empty").mkdir()
    with pytest.raises(SystemExit, match="no ckpt_"):
        port_ckpt_diff.main([str(tmp_path / "empty"), str(tmp_path)])


def test_check_trace_passes_the_ports_trace_dir(trace_run):
    rc, out = _quiet(check_trace.main, [str(trace_run)])
    assert rc == 0, out
    assert out.startswith("ok: trace.json, metrics.jsonl, manifest.json")
    assert (trace_run / "summary.txt").exists()


def test_check_trace_fails_a_damaged_copy(trace_run, tmp_path):
    copy = tmp_path / "trace"
    shutil.copytree(trace_run, copy)
    (copy / "manifest.json").unlink()
    text = (copy / "trace.json").read_text()
    (copy / "trace.json").write_text(text.replace('"round markers"',
                                                  '"rounds"'))
    rc, out = _quiet(check_trace.main, [str(copy)])
    assert rc == 1
    assert "manifest.json: missing" in out and "round markers" in out
