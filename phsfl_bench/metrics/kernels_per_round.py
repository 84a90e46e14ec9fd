"""kernels_per_round: device kernels (copies and fills left out) in the
traced rounds, over their number."""

from phsfl_bench.trace import is_kernel


def read(ctx):
    if ctx["kind"] != "phsfl_round":
        return None
    n = sum(1 for _, _, name in ctx["trace"]["device"] if is_kernel(name))
    return n / ctx["traced_units"]
