"""A cell, a traffic mix and a configuration are found by name: a
throwaway cell added to a temporary copy of the benchmark as new files
and a new BENCHMARK.json entry loads without an edit to any file."""

import json
import shutil

from phsfl_bench import harness


def test_new_cell_found_by_name(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(harness.BENCH, root / "phsfl_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    traffic = {"kind": "phsfl_round", "clients": 2, "edge_servers": 1,
               "kappa0": 1, "micro": 1, "seq": 512, "lr": 4.0,
               "why": "throwaway"}
    (root / "phsfl_bench" / "traffic" / "tiny-mix.json").write_text(
        json.dumps(traffic))
    (root / "phsfl_bench" / "limits" / "tiny-cell.json").write_text(
        json.dumps({"loss": 1.0}))
    bench["workloads"].append({"name": "tiny-cell",
                               "config": "olmoe-1b-7b-4l",
                               "traffic": "tiny-mix", "chips": 1,
                               "why": "throwaway"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    copy = harness.load_module(root / "phsfl_bench" / "harness.py",
                               "copied_harness")
    cell = copy.load_cell("tiny-cell")
    assert cell.traffic == traffic
    assert cell.config["name"] == "olmoe-1b-7b-4l"
    assert cell.limits == {"loss": 1.0}
    assert {m["name"] for m in cell.end_to_end} == {"peak_mem_gb",
                                                    "setup_s"}
