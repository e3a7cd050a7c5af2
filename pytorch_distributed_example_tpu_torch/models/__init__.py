"""Models of the port: the TransformerLM (its train path dense or MoE, on
one card or over an fsdp x tp mesh, and its KV-cache decode path),
`generate()`, the MNIST ConvNet, and their flax converters."""

from .convert import (  # noqa: F401
    cache_from_flax,
    cache_to_flax,
    convnet_from_flax,
    from_flax,
    to_flax,
)
from .generate import generate, init_cache, sample_logits  # noqa: F401
from .convnet import ConvNet  # noqa: F401
from .transformer import (  # noqa: F401
    TransformerConfig,
    TransformerLM,
    sharding_rules as transformer_sharding_rules,
)
