"""Device milliseconds a step in the port's `gemm` region (`Dense`'s
`F.linear`: every projection and the LM head), forward and backward."""

from perfbench import regions


def read(run):
    return regions.region_ms(run, "gemm")
