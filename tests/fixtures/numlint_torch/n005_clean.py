"""N005 negative (torch idiom): each draw gets a fresh key from
`prng.split`, and two draws from one `torch.Generator` are no reuse (it
advances its own state): numlint must stay quiet.

Fixture corpus: linted as AST only, never imported.
"""

import torch

from pytorch_distributed_example_tpu_torch import prng
from pytorch_distributed_example_tpu_torch.numerics import numerics_contract


@numerics_contract("token_exact")
def sample_pair_ok(key):
    keys = prng.split(key)
    a = prng.uniform(keys[0], (4,))
    b = prng.categorical(keys[1], a)
    return a, b


@numerics_contract("token_exact")
def sample_tokens_ok(gen, probs):
    first = torch.multinomial(probs, 1, generator=gen)
    return first, torch.multinomial(probs, 1, generator=gen)
