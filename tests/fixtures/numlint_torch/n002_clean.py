"""N002 negative (torch idiom): the same decomposition (the port's
`ProcessGroup` form included) under a TOLERANCE contract: reassociation
is inside a tolerance envelope's budget, so numlint must stay quiet.

Fixture corpus: linted as AST only, never imported.
"""

from pytorch_distributed_example_tpu_torch.nn import functional as nnf
from pytorch_distributed_example_tpu_torch.numerics import numerics_contract


def scatter_grads_tol(flat, group, out):
    # clean: only bitwise contracts forbid reassociation
    group.reduce_scatter_tensor(out, flat)
    return nnf.reduce_scatter(flat, "dp", 0)


@numerics_contract("tolerance", rtol=1e-5, atol=1e-6)
def approx_update(flat, group, out):
    return scatter_grads_tol(flat, group, out)
