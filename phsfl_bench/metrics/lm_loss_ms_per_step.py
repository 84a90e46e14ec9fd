"""lm_loss_ms_per_step: the device's busy ms inside the port's
``lm_loss`` and ``lm_loss.backward`` spans (the chunked cross-entropy
and its recomputing backward) in the traced rounds, over their
``phsfl.local_step`` spans (``phsfl_bench/spans.py``)."""

from phsfl_bench import spans


def read(ctx):
    if ctx["kind"] != "phsfl_round":
        return None
    got = spans.traced(ctx, "phsfl.round")
    if got is None:
        return None
    steps = spans.count(got[0], "phsfl.local_step")
    return spans.device_ms(ctx, got[0],
                           ("lm_loss", "lm_loss.backward")) / steps
