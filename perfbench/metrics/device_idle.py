"""Share of the profiled steps' span, synchronise to synchronise, in which
no operation ran on the device, in %."""


def read(run):
    p = run.profile
    if p is None or p.span_s <= 0 or not p.device_ops:
        return None
    return 100.0 * (1.0 - p.busy_s() / p.span_s)
