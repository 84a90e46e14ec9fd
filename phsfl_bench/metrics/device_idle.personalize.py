"""device_idle.personalize: 100 x (1 - the device's busy seconds a bank
over the untraced window's seconds a bank), on head banks.  Busy time
is the union of the device's intervals in the traced banks; the
profiler slows the host's launches, so the traced banks' own length
would read its cost as idle time."""


def read(ctx):
    if ctx["kind"] != "head_bank":
        return None
    busy = ctx["trace"]["busy_us"] / 1e6 / ctx["traced_units"]
    return 100.0 * (1.0 - busy / (ctx["window_s"] / ctx["units"]))
