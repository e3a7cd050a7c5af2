"""Device milliseconds a step in the port's `gqa_copy` region (the
`repeat_interleave` copies of K and V for grouped-query attention), forward
and backward."""

from perfbench import regions


def read(run):
    return regions.region_ms(run, "gqa_copy")
