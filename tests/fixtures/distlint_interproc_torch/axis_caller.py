"""R004 holds a group-taking function to forwarding its group into the
collectives that take one; the axis-scoped rank collectives take none."""

import torch.distributed as tdist

from . import axis_ops


def traced_seam(x, axis_name, group=None):
    # clean: the choice reads `group`, the collective runs over the axis
    out = axis_ops.all_reduce(x, None, axis_name)
    return axis_ops.all_gather(out, axis_name, 0)


def eager_seam(x, group=None):
    tdist.all_reduce(x)  # expect: R004
    return x
