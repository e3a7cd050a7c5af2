"""N006 positive (torch idiom): host nondeterminism inside a
`torch.compile`d body: a wall-clock read and a set-literal iteration.
The clock value is baked into the trace on one run and replayed on every
other; set order is hash-seed dependent, so the traced program itself
differs between processes.

Fixture corpus: linted as AST only, never imported.
"""

import time

import torch


@torch.compile
def stamped_scale(x):
    # MUST FIRE N006: traced-in wall clock
    t = time.time()
    acc = x * t
    # MUST FIRE N006: set iteration order feeds the trace
    for s in {2, 3, 5}:
        acc = acc + s
    return acc
