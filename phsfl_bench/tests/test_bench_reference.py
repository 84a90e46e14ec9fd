"""The plain references against the port on the CPU, at reduced sizes in
float32: the layout of every configuration, and whole runs of the
harness (set-up, window, check) whose check holds program and reference
to round-off."""

import pytest

from phsfl_bench import harness
from phsfl_bench.reference.common import paths
from phsfl_bench.tests import small


@pytest.mark.parametrize("cell", ["olmoe4-phsfl", "seamless-phsfl"])
def test_layout_is_the_ports_at_full_size(cell):
    from repro_torch.core.phsfl import abstract_params
    from repro_torch.models.registry import build_model
    c = harness.load_cell(cell)
    prog = harness.program_config(c.config)
    want = {p: (tuple(t.shape), t.dtype) for p, t in paths(
        abstract_params(build_model(prog)))}
    lay = harness.family(c.config).layout(c.config)
    assert {p: (shape, dt) for p, (shape, dt, _) in lay.items()} == want


@pytest.mark.parametrize("family,traffic", [
    ("olmoe", small.ROUND), ("seamless", small.ENCDEC_ROUND),
    ("olmoe", small.BANK)], ids=["olmoe-round", "seamless-round", "bank"])
def test_program_equals_reference(family, traffic):
    res = small.run(family, traffic)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] >= 1
    assert list(res)[-1] == "checks"


def test_traced_run_reports_per_layer_metrics():
    res = small.run("olmoe", small.ROUND, trace=True)
    assert res["correct"], res["checks"]
    m = res["metrics"]
    assert m["moe_host_reads_per_step"]["value"] == 3.0    # 3 MoE layers
    assert m["mfu.train"]["value"] > 0
    assert "breakdown" in res and "busy_s" in res["device"]


def test_config_numbers_are_the_ports():
    for cell in ("olmoe4-phsfl", "seamless-phsfl"):
        c = harness.load_cell(cell)
        prog = harness.program_config(c.config)
        assert prog.num_layers == c.config["num_layers"]
