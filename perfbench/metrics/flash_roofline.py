"""The flash kernels' share of their roofline, in %: the summed bound of
every flash launch in the profiled steps over their summed device time. A
launch's bound is `flops.attention_kernel_work` at the model's shapes (K and
V at the configuration's KV heads) over the card's peaks."""

from perfbench import spec


def read(run):
    p, bounds = run.profile, run.kernel_bound_ms
    if p is None or not bounds:
        return None
    bound = spent = 0.0
    pattern = spec.metric_reader("flash_ms").PATTERN
    for name, _, dur in p.device_ops:
        m = pattern.search(name)
        if m:
            bound += bounds[m.group(1)]
            spent += dur * 1e-3
    return 100.0 * bound / spent if spent > 0 else None
