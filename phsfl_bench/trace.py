"""The traced window: device intervals from ``torch.profiler`` and what
the host was doing in the device's idle gaps.

The measured window runs untraced: the profiler slows the host's
launches (by a fifth to a third a seamless round, even on the device
alone), and a window read under it would count that cost as the
device's idle time.  A few units after it are traced on the device
alone (tracing every host operator as well slows a host-bound step by
up to half); one further unit is traced with the host's operators, to
name the gaps.  Device
events are read from the profiler's raw results (without its event
tree: a window holds hundreds of thousands of kernels); the harness's
own ranges (``bench.*``), which the profiler also draws on the device's
timeline, are left out.  Busy time is the union of the device intervals
(kernels, copies and fills), so overlapping work counts once; an idle
gap is a stretch between two device intervals, named by the innermost
host operator that covers its midpoint.
"""

from __future__ import annotations

import bisect

GAP_FLOOR_US = 1.0           # gaps shorter than this are not named


def start(torch, host: bool = False):
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host else [])
    if not torch.cuda.is_available():       # the CPU tests: host alone
        acts = [ProfilerActivity.CPU]
    prof = profile(activities=acts)
    prof.__enter__()
    return prof


def stop(torch, prof) -> dict:
    """Stop ``prof`` and reduce its trace: device intervals (name, start
    and end in us), host operator intervals, and the union's busy us."""
    prof.__exit__(None, None, None)
    raw = getattr(prof.profiler, "kineto_results", None)
    if raw is None:
        raise RuntimeError("the profiler exposes no kineto_results")
    dev, host = [], []
    for e in raw.events():
        s, dur = e.start_ns() / 1e3, e.duration_ns() / 1e3
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if not e.name().startswith("bench."):
                dev.append((s, s + dur, e.name()))
        elif dur > 0:
            host.append((s, s + dur, e.name()))
    dev.sort()
    host.sort()
    busy, reach, gaps = 0.0, None, []
    for s, t, _ in dev:
        if reach is None or s > reach:
            if reach is not None:
                gaps.append((reach, s))
            busy += t - s
            reach = t
        elif t > reach:
            busy += t - reach
            reach = t
    marks = [h for h in host if h[2].startswith("bench.")]
    return {"device": dev, "host": host, "marks": marks, "busy_us": busy,
            "gaps": gaps}


def is_kernel(name: str) -> bool:
    return not name.startswith(("Memcpy", "Memset"))


def device_ops(tr: dict, n: int = 10) -> list:
    """The ``n`` device operations that took the most time: [name,
    seconds]."""
    by = {}
    for s, t, name in tr["device"]:
        by[name] = by.get(name, 0.0) + (t - s)
    top = sorted(by.items(), key=lambda kv: -kv[1])[:n]
    return [[name[:120], us / 1e6] for name, us in top]


def idle_gaps(tr: dict, n: int = 10) -> list:
    """The idle time summed by the host operator that covered each gap's
    midpoint, the ``n`` largest: [name, seconds]."""
    host = tr["host"]
    starts = [h[0] for h in host]
    by = {}
    for a, b in tr["gaps"]:
        if b - a < GAP_FLOOR_US:
            continue
        mid = (a + b) / 2
        name, best = "(no host operator)", None
        for s, t, nm in tr["marks"]:        # the harness's own spans
            if s <= mid <= t and (best is None or s > best):
                name, best = nm, s
        i = bisect.bisect_right(starts, mid)
        # the innermost covering operator: the latest start that still
        # covers mid, among a bounded look-back
        for j in range(i - 1, max(-1, i - 4000), -1):
            s, t, nm = host[j]
            if t >= mid:
                name = nm
                break
        by[name] = by.get(name, 0.0) + (b - a)
    top = sorted(by.items(), key=lambda kv: -kv[1])[:n]
    return [[name[:120], us / 1e6] for name, us in top]
