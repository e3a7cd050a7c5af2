"""Tokens trained a second: every step of the window times its tokens, over
the window's wall time by the host clock (a synchronise after the warm-up
opens it; the first step boundary after `--seconds` and a synchronise close
it). All the work over all the time."""


def read(run):
    w = run.window
    if w.steps == 0 or w.wall_s <= 0:
        return None
    return w.steps * w.tokens_per_step / w.wall_s
