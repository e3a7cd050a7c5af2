"""Device milliseconds a step in the port's `attention` region (the flash
kernels and their layout copies), forward and backward."""

from perfbench import regions


def read(run):
    return regions.region_ms(run, "attention")
