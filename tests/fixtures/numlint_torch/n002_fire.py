"""N002 positive (torch idiom): a rank-stacked reduce-scatter from the
port's `nn/functional.py` reachable from a bitwise contract, with no
parity-preserving whitelist entry for this file.

Fixture corpus: linted as AST only, never imported.
"""

from pytorch_distributed_example_tpu_torch.nn import functional as nnf
from pytorch_distributed_example_tpu_torch.numerics import numerics_contract


def scatter_grads(flat):
    # MUST FIRE N002: geometry changes reassociate these partial sums
    return nnf.reduce_scatter(flat, "dp", 0)


@numerics_contract("bitwise")
def sharded_update(flat):
    return scatter_grads(flat)
