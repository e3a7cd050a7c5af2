"""Device milliseconds a step in the port's `embed` region (the embedding's
lookup and cast; its backward's scatter), forward and backward."""

from perfbench import regions


def read(run):
    return regions.region_ms(run, "embed")
