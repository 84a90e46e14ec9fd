"""One run of one cell: set-up, the measured window, the traced window's
readings, and the check against the plain reference.

Everything a cell is made of is found by name: the cell's entry in
``BENCHMARK.json`` names its configuration (``configs/<name>.json``) and
its traffic (``traffic/<name>.json``); the traffic names its kind, the
code that drives one unit of work (``kinds/<kind>.py``); the
configuration names its plain reference (``reference/<name>.py``); each
per-layer metric is read by ``metrics/<metric>.py``; each cell's limits
are in ``limits/<cell>.json``.  Adding a cell, a traffic mix, a metric
or a configuration adds files and entries, and edits none.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import math
import os
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
MASK62 = (1 << 62) - 1
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
TRACED_UNITS = 3          # units traced after the untraced window


def sub_seed(seed: int, *tags) -> int:
    """A 62-bit seed derived from the run's seed and ``tags``
    (splitmix64 over their bytes)."""
    z = int(seed) & ((1 << 64) - 1)
    for t in tags:
        for ch in str(t).encode() + b"\0":
            z = (z + 0x9E3779B97F4A7C15 + ch) & ((1 << 64) - 1)
            z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & ((1 << 64) - 1)
            z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & ((1 << 64) - 1)
            z ^= z >> 31
    return z & MASK62


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def manifest() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    name: str
    config: dict           # configs/<name>.json
    traffic: dict          # traffic/<name>.json
    limits: dict           # limits/<cell>.json
    end_to_end: list       # BENCHMARK.json metrics this cell reports
    per_layer: list

    @property
    def kind(self) -> str:
        return self.traffic["kind"]


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, bench: dict | None = None) -> Cell:
    bench = bench or manifest()
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    cfg_entry = next(c for c in bench["configs"]
                     if c["name"] == entry["config"])
    return Cell(name=name,
                config=load_json(ROOT / cfg_entry["file"]),
                traffic=load_json(BENCH / "traffic"
                                  / f"{entry['traffic']}.json"),
                limits=load_json(BENCH / "limits" / f"{name}.json"),
                end_to_end=[m for m in bench["end_to_end"]
                            if _reports(m, name)],
                per_layer=[m for m in bench["per_layer"]
                           if _reports(m, name)])


def family(config: dict):
    return importlib.import_module(
        f"phsfl_bench.reference.{config['reference']}")


def kind_module(kind: str):
    return load_module(BENCH / "kinds" / f"{kind}.py",
                       f"phsfl_bench.kinds.{kind}")


def program_config(config: dict):
    """The port's ``ModelConfig`` as the configuration file states it:
    the port's registered architecture with the file's numbers put in,
    then every number of the file checked against it."""
    from repro_torch.configs import base
    from repro_torch.configs.registry import get_arch
    prog = get_arch(config["arch"])
    fields = {f.name for f in dataclasses.fields(prog)}
    over = {}
    for k, v in config.items():
        if k not in fields or k in ("name", "source"):
            continue
        if k == "moe":
            v = base.MoEConfig(**v)
        elif k == "encdec":
            v = base.EncDecConfig(**v)
        elif k == "block_pattern":
            v = tuple(v)
        over[k] = v
    prog = dataclasses.replace(prog, **over)
    got = dataclasses.asdict(prog)
    for k in over:
        want = config[k]
        have = list(got[k]) if k == "block_pattern" else got[k]
        if have != want:
            raise ValueError(f"{config['name']}: {k} is {have!r} in the "
                             f"port, {want!r} in the file")
    return prog


def process_age_s() -> float:
    """Seconds since this process started (``/proc``'s clock ticks)."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        up = float(f.read().split()[0])
    return up - start_ticks / os.sysconf("SC_CLK_TCK")


@dataclasses.dataclass
class Run:
    """What a kind's unit needs: the cell, its seed and device, the
    configuration in the port's form, and the reference's family."""
    cell: Cell
    seed: int
    device: str
    program_cfg: object
    family: object

    @property
    def cfg(self) -> dict:
        return self.cell.config

    @property
    def traffic(self) -> dict:
        return self.cell.traffic

    def seed_for(self, *tags) -> int:
        return sub_seed(self.seed, *tags)


def set_caches() -> None:
    """Build and kernel caches at fixed paths inside the checkout."""
    cache = ROOT / ".bench_cache"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_ext"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))


def metric_value(m: dict, value: float) -> dict:
    return {"value": value, "unit": m["unit"]}


def read_per_layer(cell: Cell, ctx: dict) -> dict:
    out = {}
    for m in cell.per_layer:
        reader = load_module(BENCH / "metrics" / f"{m['name']}.py",
                             f"phsfl_bench.metrics.{m['name']}")
        v = reader.read(ctx)
        if v is not None:
            out[m["name"]] = metric_value(m, v)
    return out


def median(xs) -> float:
    xs = sorted(xs)
    n = len(xs)
    return xs[n // 2] if n % 2 else 0.5 * (xs[n // 2 - 1] + xs[n // 2])


def worst(values) -> float:
    """The largest of ``values``, or NaN when any is NaN (``max`` alone
    skips a NaN that is not first)."""
    values = list(values)
    return float("nan") if any(v != v for v in values) else max(values)


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """Each compared number beside its limit; correct when every number
    is finite and within it."""
    checks, ok = {}, True
    for name, value in numbers.items():
        lim = limits[name]
        good = math.isfinite(value) and value <= lim
        ok = ok and good
        # JSON has no NaN or infinity: a non-finite number prints as null
        checks[name] = {"value": value if math.isfinite(value) else None,
                        "limit": lim}
    missing = set(limits) - set(numbers)
    if missing:
        ok = False
        for name in sorted(missing):
            checks[name] = {"value": None, "limit": limits[name]}
    return ok, checks


def note(what: str) -> None:
    """A line on standard error: ``what``, at the process's age."""
    print(f"[bench] {what} at {process_age_s():.2f} s", file=sys.stderr,
          flush=True)


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def run_cell(cell: Cell, *, seed: int, seconds: float, trace: bool,
             device: str = "cuda", program_cfg=None,
             device_info=None) -> dict:
    """One run: the result's dict (``checks`` last).  ``program_cfg``
    replaces the port's configuration (the CPU tests' small sizes)."""
    import torch
    prog = program_cfg or program_config(cell.config)
    run = Run(cell, seed, device, prog, family(cell.config))
    kind = kind_module(cell.kind)
    sync = (torch.cuda.synchronize if device == "cuda" else lambda: None)
    note("set-up starts")
    unit = kind.Unit(run)                       # set-up, warm-up, capture
    sync()
    note("set-up done")
    setup_peak = (torch.cuda.max_memory_allocated() if device == "cuda"
                  else 0)
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    setup_s = process_age_s()
    counters0 = unit.counters()
    units = attempted = failed = 0
    t0 = time.perf_counter()
    ends = []
    while True:
        with torch.profiler.record_function("bench.unit"):
            a, f = unit.step()
        sync()
        ends.append(time.perf_counter() - t0)
        units += 1
        attempted += a
        failed += f
        if time.perf_counter() - t0 >= seconds:
            break
    window_s = time.perf_counter() - t0
    window_peak = (torch.cuda.max_memory_allocated() if device == "cuda"
                   else 0)
    ctx = {"kind": cell.kind, "window_s": window_s, "units": units,
           "attempted": attempted, "counters": unit.counters(counters0),
           "work": unit.work(units), "peaks": load_json(BENCH
                                                         / "peaks.json")}
    metrics, breakdown = {}, None
    if trace:
        # The profiler slows the host's launches, so the window above is
        # untraced; TRACED_UNITS more units are traced on the device.
        from phsfl_bench import trace as tr_mod
        prof = tr_mod.start(torch)
        t1 = time.perf_counter()
        for _ in range(TRACED_UNITS):
            with torch.profiler.record_function("bench.unit"):
                a, f = unit.step()
            sync()
            attempted += a
            failed += f
        traced_s = time.perf_counter() - t1
        reduced = tr_mod.stop(torch, prof)
        note(f"traced {TRACED_UNITS} units in {traced_s:.3f} s: "
             f"{traced_s / TRACED_UNITS / (window_s / units):.4f} of an "
             f"untraced unit")
        ctx.update(trace=reduced, traced_units=TRACED_UNITS,
                   traced_s=traced_s, traced_work=unit.work(TRACED_UNITS))
        metrics = read_per_layer(cell, ctx)
        busy_s = reduced["busy_us"] / 1e6
        ops = tr_mod.device_ops(reduced)
        del reduced, ctx["trace"]
        prof = tr_mod.start(torch, host=True)  # one more unit, host named
        with torch.profiler.record_function("bench.unit"):
            unit.step()
        sync()
        breakdown = {"device_ops": ops,
                     "idle_gaps": tr_mod.idle_gaps(tr_mod.stop(torch, prof))}
    else:
        e2e = unit.end_to_end(window_s, units, attempted)
        e2e["setup_s"] = setup_s
        e2e["peak_mem_gb"] = window_peak / 1e9
        metrics = {m["name"]: metric_value(m, e2e[m["name"]])
                   for m in cell.end_to_end}
    run_peak = (torch.cuda.max_memory_allocated() if device == "cuda"
                else 0)
    unit.release()
    del unit
    note(f"window closed: {units} units in {window_s:.3f} s, each "
         + " ".join(f"{b - a:.4f}" for a, b in zip([0.0] + ends, ends)))
    numbers = kind.check(run)                   # the plain reference
    note("reference done")
    correct, checks = judge(numbers, cell.limits)
    info = dict(device_info or {})
    info["memory_peak_bytes"] = max(setup_peak, run_peak)
    if trace:
        info["busy_s"] = busy_s
        info["window_s"] = traced_s
    result = {"correct": correct and failed == 0, "attempted": attempted,
              "failed": failed, "metrics": metrics, "device": info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    return result
