"""Nothing the benchmark runs loads JAX or the JAX package (top-level
names compared whole: ``repro_torch`` is not ``repro``), and the plain
references import nothing of the port."""

import ast
import subprocess
import sys

from phsfl_bench import harness

LOAD_ALL = r"""
import sys, glob, os
sys.path[:0] = [{src!r}, {root!r}]
from phsfl_bench import harness, control, feed, flops, trace, weights, run
from phsfl_bench.reference import common, decoder, encdec, phsfl
bench = harness.manifest()
for w in bench["workloads"]:
    cell = harness.load_cell(w["name"], bench)
    harness.kind_module(cell.kind)
    harness.family(cell.config)
    harness.program_config(cell.config)
for m in bench["per_layer"]:
    harness.load_module(harness.BENCH / "metrics" / (m["name"] + ".py"), m["name"])
import repro_torch.core.phsfl, repro_torch.core.personalize
import repro_torch.models.registry
print(sorted({{m.split(".")[0] for m in sys.modules}}))
"""


def test_no_jax_or_reference_package_loaded():
    code = LOAD_ALL.format(src=str(harness.ROOT / "src"),
                           root=str(harness.ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, check=True).stdout
    tops = set(eval(out.strip().splitlines()[-1]))
    assert not tops & {"jax", "jaxlib", "flax", "repro"}, tops
    assert "repro_torch" in tops and "phsfl_bench" in tops


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_references_import_nothing_of_the_port():
    for path in (harness.BENCH / "reference").glob("*.py"):
        for name in _imports(path):
            assert name.split(".")[0] in ("torch", "math", "phsfl_bench",
                                          "__future__"), (path, name)
            if name.startswith("phsfl_bench"):
                assert name.startswith("phsfl_bench.reference"), (path, name)


def test_no_module_of_the_benchmark_imports_jax():
    for path in harness.BENCH.rglob("*.py"):
        for name in _imports(path):
            assert name.split(".")[0] not in ("jax", "jaxlib", "flax",
                                              "repro"), (path, name)
