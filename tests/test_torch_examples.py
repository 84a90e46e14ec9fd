"""Port parity for the examples: each ``examples/port_<name>.py`` against
the reference's ``examples/<name>.py`` on the same argv.

- The scheduler-only examples (``faulty_phsfl``, ``pipelined_phsfl``,
  ``device_aware_cut``) run the numpy oracle on both sides: the port's
  stdout equals the reference's character for character.  The reference
  runs by ``runpy`` under ``reference_wireless()`` (R1 in ROADMAP.md).
- The FedSim examples take the same patches in the example's namespace
  on both sides: ``test_torch_fedsim.py``'s small CNN and data sizes, a
  ``FedSim`` whose constructor records the reference's initial
  ``state_dict()`` and loads it into the port's (in creation order),
  rounds capped at 2, and ``link_codecs`` with deterministic rounding.
  The numbers the scheduler gives (tables, scheduled, participating,
  bits, the simulated clock) are equal; accuracies and gains agree
  within ``test_torch_fedsim.py``'s tolerances, plus one unit of the
  printed precision.
- The wrappers (``quickstart``, ``serve_personalized``,
  ``multipod_dryrun_demo``) hand their launcher the reference's argv,
  the module name aside.
Each port example that builds a FedSim or calls a launcher raises with
no card and no ``--device``.
"""

import contextlib
import importlib.util
import io
import re
import runpy
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_wireless_oracle import reference_wireless

from repro_torch.compress import link_codecs as t_link_codecs
from repro_torch.configs import CNNConfig
from repro_torch.core.fedsim import FedSim

EXAMPLES = Path(__file__).resolve().parent.parent / "examples"
# tests/test_torch_fedsim.py's sizes
SMALL = dict(image_size=16, conv1_filters=8, conv2_filters=16, fc_hidden=32)
DATA = dict(image_size=16, train_per_class=30, test_per_class=10)
ROUNDS = 2


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's side on one intra-op thread.  The tier-1 run puts six
    test processes on eight cores; torch's default of a thread a core
    then spends most of a small op waiting on the others (and starves the
    reference's side): this file's FedSim runs took 50x their time alone
    there.  The tolerances and assertions are the same at any thread
    count."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _port(name):
    return _load(EXAMPLES / f"port_{name}.py", f"_port_example_{name}")


def _stdout(fn, *args):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(*args)
    return buf.getvalue()


# ------------------------------------------------- scheduler-only examples --

SCHEDULER_ONLY = {
    "faulty_phsfl": [[], ["--erasure", "0.5", "--rounds", "5",
                          "--client", "3", "--seed", "1"]],
    "pipelined_phsfl": [[], ["--deadline", "2.0", "--compute-gflops", "0.3",
                             "--client", "5", "--seed", "2"]],
    "device_aware_cut": [[], ["--compute-gflops", "2", "--deadline", "3.0",
                              "--seed", "1"]],
}
CASES = [(n, i) for n in SCHEDULER_ONLY for i in range(2)]


def _reference_stdout(name, argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", [f"{name}.py", *argv])
    with reference_wireless():
        return _stdout(runpy.run_path, str(EXAMPLES / f"{name}.py"),
                       None, "__main__")


@pytest.mark.parametrize("name,case", CASES,
                         ids=[f"{n}-{'default' if i == 0 else 'flags'}"
                              for n, i in CASES])
def test_scheduler_only_example_prints_the_reference(name, case,
                                                     monkeypatch):
    argv = SCHEDULER_ONLY[name][case]
    want = _reference_stdout(name, argv, monkeypatch)
    got = _stdout(_port(name).main, argv)
    assert want.count("\n") > 5
    assert got == want


# -------------------------------------------------------- FedSim examples --

FEDSIM_EXAMPLES = {
    # name: (argv, the test samples a client's accuracy may differ by)
    "personalized_federation": ([], 0),
    "wireless_phsfl": ([], 0),
    "adaptive_cut": ([], 0),
    "compressed_phsfl": ([], 1),      # int8-det: test_torch_fedsim.py
}


def _small_data(make):
    def data(num_clients, alpha, **kw):
        return make(num_clients, alpha, **{**kw, **DATA})
    return data


def _reference_fedsim_run(name, argv, monkeypatch):
    """The reference example under the patches: its stdout and each
    FedSim's initial state, in creation order."""
    import jax
    from repro.compress import link_codecs
    from repro.configs.phsfl_cnn import CNNConfig as JCNNConfig
    states, tests = [], []
    monkeypatch.setattr(sys, "argv", [f"{name}.py", *argv])
    with reference_wireless():
        mod = _load(EXAMPLES / f"{name}.py", f"_reference_example_{name}")

        class Recorded(mod.FedSim):
            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                states.append(jax.tree.map(np.asarray, self.state_dict()))
                tests.append([min(len(i), 256)
                              for i in self.data.test_indices])

            def run(self, rounds=None, log_every=5):
                return super().run(rounds=min(rounds, ROUNDS),
                                   log_every=log_every)

        mod.FedSim = Recorded
        mod.CNN_CFG = JCNNConfig(**SMALL)
        mod.make_federated_image_data = _small_data(
            mod.make_federated_image_data)
        if hasattr(mod, "link_codecs"):
            mod.link_codecs = lambda n, **kw: link_codecs(
                n, stochastic=False, **kw)
        out = _stdout(mod.main)
    # every FedSim of an example trains on the same data: an accuracy
    # averaged over clients moves by samples x mean(1 / n_test) at most
    assert all(t == tests[0] for t in tests)
    return out, states, float(np.mean(1.0 / np.asarray(tests[0])))


def _port_fedsim_run(name, argv, states):
    mod = _port(name)
    todo = list(states)

    class Loaded(FedSim):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.load_state_dict(todo.pop(0))

        def run(self, rounds=None, log_every=5):
            return super().run(rounds=min(rounds, ROUNDS),
                               log_every=log_every)

    mod.FedSim = Loaded
    mod.CNN_CFG = CNNConfig(**SMALL)
    mod.make_federated_image_data = _small_data(
        mod.make_federated_image_data)
    if hasattr(mod, "link_codecs"):
        mod.link_codecs = lambda n, **kw: t_link_codecs(
            n, stochastic=False, **kw)
    out = _stdout(mod.main, [*argv, "--device", "cpu"])
    assert not todo
    return out


NUMBER = re.compile(r"([-+]?\d[\d,]*(?:\.\d+)?)")


def _learned(line: str, before: str) -> bool:
    """A number that training gives (an accuracy, a gain): after 'acc',
    the deadline's accuracy cost, or any of a results-table row."""
    return (re.search(r"acc\s*$", before) is not None
            or (line.startswith("accuracy cost") and before.endswith(": "))
            or line.split(" ")[0] in ("phsfl", "hsfl"))


def _compare(got: str, want: str, samples: int, inv_test: float):
    """Same lines and text; scheduler numbers equal; learned numbers (a
    mean accuracy over clients, or a difference of two) within twice
    ``samples`` test samples a client, ``inv_test`` the mean of 1 / a
    client's test count, plus one unit of the printed precision."""
    got_lines, want_lines = got.splitlines(), want.splitlines()
    assert len(got_lines) == len(want_lines), (got, want)
    n_learned = 0
    for g, w in zip(got_lines, want_lines):
        gp, wp = NUMBER.split(g), NUMBER.split(w)
        assert len(gp) == len(wp), (g, w)
        assert gp[0::2] == wp[0::2], (g, w)          # the text
        for i in range(1, len(wp), 2):
            if not _learned(w, "".join(wp[:i])):
                assert gp[i] == wp[i], (g, w)
                continue
            n_learned += 1
            unit = 10.0 ** -len(wp[i].partition(".")[2])
            tol = 2 * samples * inv_test + unit + 1e-12
            assert abs(float(gp[i]) - float(wp[i])) <= tol, (g, w)
    return n_learned


@pytest.mark.parametrize("name", sorted(FEDSIM_EXAMPLES))
def test_fedsim_example_matches_the_reference(name, monkeypatch):
    argv, samples = FEDSIM_EXAMPLES[name]
    want, states, inv_test = _reference_fedsim_run(name, argv,
                                                   monkeypatch)
    got = _port_fedsim_run(name, argv, states)
    assert _compare(got, want, samples, inv_test) >= 2
    if name == "compressed_phsfl":
        parts = re.findall(r"participating ([\d.]+)/8", want)
        assert len(parts) == 3


# --------------------------------------------------------------- wrappers --

WRAPPERS = {"quickstart": ("repro.launch.train", "train_main"),
            "serve_personalized": ("repro.launch.serve", "serve_main")}
WRAPPER_ARGV = {"quickstart": [[], ["--arch", "xlstm-350m", "--rounds", "2"]],
                "serve_personalized": [[], ["--arch", "gemma3-12b"]]}


def _reference_launcher_argv(name, argv, monkeypatch):
    module, _ = WRAPPERS[name]
    seen = []
    stub = types.ModuleType(module)
    stub.main = seen.append
    monkeypatch.setitem(sys.modules, module, stub)
    monkeypatch.setattr(sys, "argv", [f"{name}.py", *argv])
    runpy.run_path(str(EXAMPLES / f"{name}.py"), run_name="__main__")
    assert len(seen) == 1
    return seen[0]


@pytest.mark.parametrize("name", sorted(WRAPPERS))
def test_wrapper_passes_the_reference_argv(name, monkeypatch):
    mod = _port(name)
    _, attr = WRAPPERS[name]
    for argv in WRAPPER_ARGV[name]:
        want = _reference_launcher_argv(name, argv, monkeypatch)
        seen = []
        monkeypatch.setattr(mod, attr, seen.append)
        mod.main(argv)
        assert seen == [want]
        mod.main([*argv, "--device", "cpu"])
        assert seen[1] == [*want, "--device", "cpu"]


def test_multipod_demo_runs_the_ports_dryrun_with_the_reference_argv(
        monkeypatch):
    calls = []

    def call(cmd, env=None):
        calls.append((cmd, env))
        return 0
    monkeypatch.setattr(subprocess, "call", call)
    for argv in ([], ["--arch", "olmoe-1b-7b", "--shape", "decode_32k",
                      "--mesh", "single"]):
        monkeypatch.setattr(sys, "argv", ["multipod_dryrun_demo.py", *argv])
        with pytest.raises(SystemExit) as exit_:
            runpy.run_path(str(EXAMPLES / "multipod_dryrun_demo.py"),
                           run_name="__main__")
        assert exit_.value.code == 0
        assert _port("multipod_dryrun_demo").main(argv) == 0
        (ref, _), (got, env) = calls[-2:]
        assert ref[:3] == [sys.executable, "-m", "repro.launch.dryrun"]
        assert got[:3] == [sys.executable, "-m", "repro_torch.launch.dryrun"]
        assert got[3:] == ref[3:]
        src = str((EXAMPLES.parent / "src").resolve())
        assert src in env["PYTHONPATH"].split(":")


# ----------------------------------------------------- the card by default --

NEEDS_DEVICE = ("personalized_federation", "wireless_phsfl", "adaptive_cut",
                "compressed_phsfl", "quickstart", "serve_personalized")


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
@pytest.mark.parametrize("name", NEEDS_DEVICE)
def test_example_raises_without_a_card_or_device(name):
    mod = _port(name)
    if hasattr(mod, "make_federated_image_data"):
        mod.make_federated_image_data = _small_data(
            mod.make_federated_image_data)
    with contextlib.redirect_stdout(io.StringIO()), \
            pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main([])
