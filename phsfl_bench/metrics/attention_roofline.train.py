"""attention_roofline.train: the least time of the traced rounds'
self-attention forwards (the larger of their FLOPs at the bf16 peak and
their bytes at the HBM bandwidth; ``phsfl_bench.flops.self_attention_work``)
over the device time of the kernels that compute them, in %.  The
kernels are those whose names match a line of
``attention_roofline.train.names.txt`` (K2's forward and PyTorch's and
cuDNN's fused attention forwards), so the share reads the same work
whichever implements it.  Attention's backward is not counted on either
side."""

import re
from pathlib import Path

NAMES = Path(__file__).with_name("attention_roofline.train.names.txt")


def read(ctx):
    if ctx["kind"] != "phsfl_round":
        return None
    pats = [re.compile(line.strip()) for line in NAMES.read_text().split("\n")
            if line.strip() and not line.startswith("#")]
    us = sum(t - s for s, t, name in ctx["trace"]["device"]
             if any(p.search(name) for p in pats))
    if not us:
        return None
    w, peaks = ctx["traced_work"], ctx["peaks"]
    least = max(w["attention_flops"] / peaks["bf16_flops_per_s"],
                w["attention_bytes"] / peaks["hbm_bytes_per_s"])
    return 100.0 * least / (us / 1e6)
