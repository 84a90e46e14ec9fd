"""On the card: at each cell's own size, the program passes the cell's
limits and the lower-precision control (the reference with every matrix
product's operands in float8 e4m3, in the program's place) fails them.
About 40 s a cell (``phsfl_bench/control.py`` takes the same readings
on many seeds).

    python -m pytest -q -m cuda phsfl_bench/tests/test_bench_control_cuda.py
"""

import pytest

from phsfl_bench import control, harness

CELLS = [w["name"] for w in harness.manifest()["workloads"]]


@pytest.fixture
def card():
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    harness.set_caches()


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_and_program_passes(card, name):
    cell = harness.load_cell(name)
    ok, checks = harness.judge(control.readings(cell, 5, "program"),
                               cell.limits)
    assert ok, checks
    ok, checks = harness.judge(control.readings(cell, 5, "control"),
                               cell.limits)
    assert not ok, checks
