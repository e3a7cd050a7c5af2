"""Device milliseconds a step in `train_step`'s optimizer phase
(`tdx.optimizer`: `zero_grad` and AdamW's `step`), opening to closing."""

from perfbench import regions


def read(run):
    return regions.phase_ms(run, "optimizer")
