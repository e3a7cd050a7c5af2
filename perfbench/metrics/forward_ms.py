"""Device milliseconds a step in `train_step`'s forward phase (`tdx.forward`:
the model and the loss), opening to closing, nested regions included."""

from perfbench import regions


def read(run):
    return regions.phase_ms(run, "forward")
