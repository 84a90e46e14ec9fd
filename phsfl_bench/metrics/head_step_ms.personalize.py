"""head_step_ms.personalize: the device's busy ms inside the port's
``personalize.head_step`` spans (one client's SGD step on its head:
``lm_loss``, its backward, the update) in the traced banks, over their
number (``phsfl_bench/spans.py``)."""

from phsfl_bench import spans


def read(ctx):
    if ctx["kind"] != "head_bank":
        return None
    got = spans.traced(ctx, "personalize.bank")
    if got is None:
        return None
    steps = spans.count(got[0], "personalize.head_step")
    return spans.device_ms(ctx, got[0], ("personalize.head_step",)) / steps
