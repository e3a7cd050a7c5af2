"""The port's `nn`: the differentiable collectives (`nn.functional`)."""

from . import functional  # noqa: F401
