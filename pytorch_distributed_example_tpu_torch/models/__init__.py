"""Models of the port: the TransformerLM train path and its flax converter."""

from .convert import from_flax  # noqa: F401
from .transformer import TransformerConfig, TransformerLM  # noqa: F401
