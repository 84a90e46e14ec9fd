"""mfu.personalize: the window's head-bank model FLOPs (the trunk's
forward over every client's tokens, plus 4 S D V a head step: logits and
the head's gradient, no recompute) over the untraced window's seconds
and the chip's bf16 peak, in %."""


def read(ctx):
    if ctx["kind"] != "head_bank":
        return None
    return (100.0 * ctx["work"]["model_flops"] / ctx["window_s"]
            / ctx["peaks"]["bf16_flops_per_s"])
