"""moe_host_reads_per_step: the change of the port's counter
``repro_torch.models.moe.group_size_reads`` (one host read of the
experts' group sizes a MoE call) over the window, per local step."""


def read(ctx):
    c = ctx["counters"]
    if ctx["kind"] != "phsfl_round" or not c.get("local_steps"):
        return None
    if not c["moe_host_reads"]:
        return None                      # a model without experts
    return c["moe_host_reads"] / c["local_steps"]
