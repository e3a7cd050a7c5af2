"""Device milliseconds a step in the port's `cast` region (`Dense`'s casts of
input and weight to the compute dtype), forward and backward."""

from perfbench import regions


def read(run):
    return regions.region_ms(run, "cast")
