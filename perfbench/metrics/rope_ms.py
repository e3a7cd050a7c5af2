"""Device milliseconds a step in the port's `rope` region (both `apply_rope`
calls of each layer, q and k), forward and backward."""

from perfbench import regions


def read(run):
    return regions.region_ms(run, "rope")
