"""aggregation_ms_per_round: the device's busy ms inside the port's
``phsfl.edge`` and ``phsfl.global`` spans (Eqs. 14-16: the weighted
means over each ES's clients and over the ESs, float32) in the traced
rounds, over their ``phsfl.round`` spans (``phsfl_bench/spans.py``)."""

from phsfl_bench import spans


def read(ctx):
    if ctx["kind"] != "phsfl_round":
        return None
    got = spans.traced(ctx, "phsfl.round")
    if got is None:
        return None
    return spans.device_ms(ctx, got[0],
                           ("phsfl.edge", "phsfl.global")) / got[1]
