"""mfu.train: the window's training model FLOPs (forward and backward of
every local step, no recompute, the frozen head's weight gradient left
out) over the untraced window's seconds and the chip's bf16 peak, in
%."""


def read(ctx):
    if ctx["kind"] != "phsfl_round":
        return None
    return (100.0 * ctx["work"]["model_flops"] / ctx["window_s"]
            / ctx["peaks"]["bf16_flops_per_s"])
