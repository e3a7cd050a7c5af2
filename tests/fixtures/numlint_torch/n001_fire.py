"""N001 positive (torch idiom): a bitwise-contracted step multiplies a
bfloat16 activation with `torch.matmul` and neither makes its operands
float32 at the call nor states the result dtype, in a module that mixes
precisions (bfloat16 below).

Fixture corpus: linted as AST only, never imported.
"""

import torch

from pytorch_distributed_example_tpu_torch.numerics import numerics_contract


def cast_for_compute(x):
    return x.to(torch.bfloat16)


@numerics_contract("bitwise")
def train_step(weight, batch):
    h = cast_for_compute(batch)
    # MUST FIRE N001: the product may reduce in reduced precision
    return torch.matmul(h, weight)
