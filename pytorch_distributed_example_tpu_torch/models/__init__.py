"""Models of the port: the TransformerLM train path, the MNIST ConvNet, and
their flax converters."""

from .convert import convnet_from_flax, from_flax  # noqa: F401
from .convnet import ConvNet  # noqa: F401
from .transformer import TransformerConfig, TransformerLM  # noqa: F401
