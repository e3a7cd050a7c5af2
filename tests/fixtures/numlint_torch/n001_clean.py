"""N001 negative (torch idiom): the same bfloat16 module, but the
product's operands are made float32 at the call (and the `@` form casts
too), so its accumulation does not float with the backend: numlint must
stay quiet.

Fixture corpus: linted as AST only, never imported.
"""

import torch

from pytorch_distributed_example_tpu_torch.numerics import numerics_contract


def cast_for_compute_ok(x):
    return x.to(torch.bfloat16)


@numerics_contract("bitwise")
def train_step_ok(weight, batch):
    h = cast_for_compute_ok(batch)
    # clean: float32 operands pin the accumulator
    y = torch.matmul(h.float(), weight.to(torch.float32))
    # clean: one operand made float32 at the `@`
    return y + h.to(dtype=torch.float32) @ weight
