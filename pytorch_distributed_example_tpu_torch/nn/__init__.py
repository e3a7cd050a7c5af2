"""The port's `nn`: the differentiable collectives (`nn.functional`) and
the gradient utilities (`nn.utils`: clipping)."""

from . import functional  # noqa: F401
from . import utils  # noqa: F401
