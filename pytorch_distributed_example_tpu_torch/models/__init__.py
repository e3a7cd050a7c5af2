"""Models of the port: the TransformerLM train path (dense or MoE, on one
card or over an fsdp x tp mesh), the MNIST ConvNet, and their flax
converters."""

from .convert import convnet_from_flax, from_flax, to_flax  # noqa: F401
from .convnet import ConvNet  # noqa: F401
from .transformer import (  # noqa: F401
    TransformerConfig,
    TransformerLM,
    sharding_rules as transformer_sharding_rules,
)
