"""N006 negative (torch idiom): the wall clock is read OUTSIDE the
`torch.func.vmap`ped body and passed in as data; iteration inside it is
over a tuple: numlint must stay quiet.

Fixture corpus: linted as AST only, never imported.
"""

import time

from torch.func import vmap


def host_timestamp():
    # clean: host code, not traced: the value enters as an argument
    return time.time()


def stamped_scale_ok(x, t):
    acc = x * t
    for s in (2, 3, 5):
        acc = acc + s
    return acc


def run(xs):
    return vmap(stamped_scale_ok, in_dims=(0, None))(xs, host_timestamp())
