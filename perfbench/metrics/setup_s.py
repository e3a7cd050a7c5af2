"""Seconds from the start of the process to the window's opening: imports,
the card, the model and optimizer, and the warm-up steps (the first run in a
checkout also builds the flash library)."""


def read(run):
    return run.setup_s
