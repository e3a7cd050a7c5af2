"""N005 positive (torch idiom, generator form): a token-exact sampler
re-seeds the `torch.Generator` it was handed, so its stream restarts and
later draws repeat earlier ones.

Fixture corpus: linted as AST only, never imported.
"""

import torch

from pytorch_distributed_example_tpu_torch.numerics import numerics_contract


@numerics_contract("token_exact")
def sample_tokens(gen, probs, seed):
    first = torch.multinomial(probs, 1, generator=gen)
    # MUST FIRE N005: the generator's stream restarts here
    gen.manual_seed(seed)
    return first, torch.multinomial(probs, 1, generator=gen)
