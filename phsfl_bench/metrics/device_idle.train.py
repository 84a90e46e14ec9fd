"""device_idle.train: 100 x (1 - the device's busy seconds a round over
the untraced window's seconds a round), on training rounds.  Busy time
is the union of the device's intervals in the traced rounds; the
profiler slows the host's launches, so the traced rounds' own length
would read its cost as idle time."""


def read(ctx):
    if ctx["kind"] != "phsfl_round":
        return None
    busy = ctx["trace"]["busy_us"] / 1e6 / ctx["traced_units"]
    return 100.0 * (1.0 - busy / (ctx["window_s"] / ctx["units"]))
