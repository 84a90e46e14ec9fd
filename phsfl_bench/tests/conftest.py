"""The benchmark's own tests (``python -m pytest phsfl_bench/tests`` from
the checkout's root): the port's package and the benchmark import from
the checkout."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))
