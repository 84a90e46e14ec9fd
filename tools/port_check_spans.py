"""Check of the PyTorch port's ``spans.json`` (``repro_torch.telemetry.spans``).

A ``Telemetry(out_dir)`` handle of the port writes its program spans to
``<out_dir>/spans.json`` beside the files ``tools/check_trace.py``
checks.  This tool checks that file: it parses, its two tracks (host and
stream) are named, every span has a finite start and a non-negative
length, every span's parent is a span of its own track, and every span
lies inside its parent (within :data:`SLACK_US`).  ``make
port-trace-smoke`` runs it after ``tools/check_trace.py``.

    python -m tools.port_check_spans build/port_smoke/trace/spans.json

Exit status 0 iff everything holds; prints one line per problem.
"""

from __future__ import annotations

import json
import math
import sys
from pathlib import Path

SLACK_US = 1.0            # a span's edges against its parent's


def check(path: Path, problems: list) -> None:
    """Append one line to ``problems`` for each fault of ``path``."""
    try:
        evs = json.loads(Path(path).read_text())
    except json.JSONDecodeError as e:
        problems.append(f"{path}: unparseable: {e}")
        return
    tracks = {ev["pid"]: ev["args"]["name"] for ev in evs
              if ev.get("ph") == "M" and ev.get("name") == "process_name"}
    if set(tracks.values()) != {"host", "stream"}:
        problems.append(f"{path}: tracks {sorted(tracks.values())}, want "
                        f"host and stream")
    spans = {}
    for i, ev in enumerate(evs):
        if ev.get("ph") != "X":
            continue
        ts, dur = ev.get("ts"), ev.get("dur")
        if not all(isinstance(v, (int, float)) and math.isfinite(v)
                   for v in (ts, dur)) or dur < 0:
            problems.append(f"{path}: span {i} bad ts/dur: {ev}")
            continue
        spans[(ev["pid"], ev["args"]["id"])] = ev
    for (pid, _), ev in spans.items():
        parent = ev["args"]["parent"]
        if parent is None:
            continue
        up = spans.get((pid, parent))
        where = f"{ev['name']} (id {ev['args']['id']}, {tracks.get(pid)})"
        if up is None:
            problems.append(f"{path}: {where} has no parent {parent}")
        elif (ev["ts"] < up["ts"] - SLACK_US
              or ev["ts"] + ev["dur"] > up["ts"] + up["dur"] + SLACK_US):
            problems.append(f"{path}: {where} lies outside its parent "
                            f"{up['name']}")


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 1:
        print("usage: python -m tools.port_check_spans <spans.json>")
        return 2
    path = Path(argv[0])
    if not path.exists():
        print(f"{path}: missing")
        return 1
    problems: list = []
    check(path, problems)
    for msg in problems:
        print(msg)
    if not problems:
        print(f"ok: {path} well-formed")
    return 1 if problems else 0


if __name__ == "__main__":
    sys.exit(main())
