"""moe_ffn_ms_per_step: the device's busy ms inside the port's
``moe.ffn`` and ``moe.ffn.backward`` spans (every MoE layer's forward
and backward) in the traced rounds, over their ``phsfl.local_step``
spans.  Busy time is the union of the device's intervals clipped to each
span's stream interval (``phsfl_bench/spans.py``): the layer's device
work, not the device's waits for the host's launches inside it."""

from phsfl_bench import spans


def read(ctx):
    if ctx["kind"] != "phsfl_round":
        return None
    got = spans.traced(ctx, "phsfl.round")
    if got is None or not spans.count(got[0], "moe.ffn"):
        return None
    steps = spans.count(got[0], "phsfl.local_step")
    return spans.device_ms(ctx, got[0],
                           ("moe.ffn", "moe.ffn.backward")) / steps
