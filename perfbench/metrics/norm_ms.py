"""Device milliseconds a step in the port's `norm` region (`RMSNorm`'s float32
arithmetic and cast back), forward and backward."""

from perfbench import regions


def read(run):
    return regions.region_ms(run, "norm")
