"""Device milliseconds a step in the port's `swiglu` region (the MLP's
`silu(gate) * up`), forward and backward."""

from perfbench import regions


def read(run):
    return regions.region_ms(run, "swiglu")
