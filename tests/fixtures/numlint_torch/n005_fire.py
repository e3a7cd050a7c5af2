"""N005 positive (torch idiom): one `prng.py` key feeds two draws with
no `split` between them, on a token-exact path: both draws see the same
stream, and replay forks.

Fixture corpus: linted as AST only, never imported.
"""

from pytorch_distributed_example_tpu_torch import prng
from pytorch_distributed_example_tpu_torch.numerics import numerics_contract


@numerics_contract("token_exact")
def sample_pair(key):
    a = prng.uniform(key, (4,))
    # MUST FIRE N005: `key` was already consumed by the draw above
    b = prng.uniform(key, (4,))
    return a, b
