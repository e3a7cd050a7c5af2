"""Device milliseconds a step in `train_step`'s backward phase (`tdx.backward`:
`loss.backward()`), opening to closing, nested regions included."""

from perfbench import regions


def read(run):
    return regions.phase_ms(run, "backward")
