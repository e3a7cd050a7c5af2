"""Device milliseconds a step in the port's `loss` region (the logits' float32
cast and the cross-entropy; the head's GEMM is `linear_ms`'s), forward and
backward."""

from perfbench import regions


def read(run):
    return regions.region_ms(run, "loss")
