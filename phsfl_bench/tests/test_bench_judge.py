"""The verdict on the compared numbers: a non-finite number fails and
prints as null, a missing one fails, and the worst gap sees a NaN
wherever it lies."""

import json
import math

import pytest

from phsfl_bench.harness import judge, worst


@pytest.mark.parametrize("values", [[float("nan"), 1.0], [1.0, float("nan")]])
def test_worst_sees_nan_anywhere(values):
    assert math.isnan(worst(values))


def test_judge():
    ok, checks = judge({"a": 0.5, "b": 0.0}, {"a": 1.0, "b": 0.0})
    assert ok and checks == {"a": {"value": 0.5, "limit": 1.0},
                             "b": {"value": 0.0, "limit": 0.0}}
    for bad in (float("nan"), float("inf"), 1.5):
        ok, checks = judge({"a": bad}, {"a": 1.0})
        assert not ok
        json.loads(json.dumps(checks, allow_nan=False))
    ok, checks = judge({}, {"a": 1.0})
    assert not ok and checks["a"]["value"] is None
