"""kernels_per_client.personalize: device kernels (copies and fills left
out) in the traced banks, over the clients whose head they fine-tuned."""

from phsfl_bench.trace import is_kernel


def read(ctx):
    if ctx["kind"] != "head_bank":
        return None
    n = sum(1 for _, _, name in ctx["trace"]["device"] if is_kernel(name))
    return n / ctx["traced_work"]["clients"]
