"""The whole step's share of the card's dense bf16 peak, in %: model FLOPs
a step (`kinds/<kind>.py` `counts`) times the unprofiled steps of the
window, over their wall time by the host clock, over the peak."""


def read(run):
    w = run.window
    if not run.peak_flops or w.steps == 0 or w.wall_s <= 0:
        return None
    return 100.0 * run.step_flops * w.steps / w.wall_s / run.peak_flops
