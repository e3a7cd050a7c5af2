"""The MNIST ConvNet, the port of the reference's `models/convnet.py`.

The topology is the canonical torch MNIST example's, as the reference has
it: conv(1→10, k5) → maxpool2 → relu → conv(10→20, k5) → dropout →
maxpool2 → relu → flatten → fc(320→50) → relu → dropout → fc(50→10). The
logits come out raw; log_softmax belongs to the loss.

Where it follows the reference rather than torch's example:
  - the 2x2 max pool is a reshape and an `amax` (`max_pool_2x2`), as the
    reference's reshape-and-max: its gradient splits the cotangent evenly
    over tied maxima, where `F.max_pool2d` sends all of it to one argmax;
  - the init is flax's: `lecun_normal` (a normal truncated at two standard
    deviations, variance 1/fan_in) for the conv and dense kernels, zero
    biases; torch's kaiming-uniform default is not used;
  - dropout draws its masks from an explicit `torch.Generator`, or takes
    them as inputs (`dropout_masks`): the driver-mode train step draws
    them outside `torch.func.vmap` and passes them in.

The layout is NCHW (torch's); the reference's is NHWC, so its flatten
orders the 320 features (h, w, c) where this one orders them (c, h, w).
`models/convert.py:convnet_from_flax` permutes `Dense_0`'s rows to match.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .transformer import resolve_device

# flax's truncated_normal(-2, 2) has this standard deviation; lecun_normal
# divides by it so the truncated draw keeps variance 1/fan_in
_TRUNC_STD = 0.87962566103423978


def max_pool_2x2(x: torch.Tensor) -> torch.Tensor:
    """2x2 stride-2 max pool over NCHW as a reshape and an `amax`.

    Needs even H and W (24x24 and 8x8 in this net). The forward equals
    `F.max_pool2d(x, 2)`; the backward splits the cotangent evenly over
    the tied maxima of a window, as the reference's `jnp.max` does."""
    b, c, h, w = x.shape
    return x.reshape(b, c, h // 2, 2, w // 2, 2).amax(dim=(3, 5))


def lecun_normal_(weight: torch.Tensor, fan_in: int,
                  generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """flax's `lecun_normal` in place: a normal truncated at +-2 standard
    deviations, scaled so that the variance is 1/fan_in."""
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    with torch.no_grad():
        return nn.init.trunc_normal_(weight, 0.0, std, -2 * std, 2 * std, generator=generator)


def _dropout(x: torch.Tensor, keep: torch.Tensor, rate: float) -> torch.Tensor:
    """flax's Dropout given its keep mask: kept entries / (1 - rate), else 0."""
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))


class ConvNet(nn.Module):
    """images (B, 1, 28, 28) float32 -> logits (B, num_classes) float32.

    Built on `device`, cuda:0 by default (it raises without a card; pass
    device="cpu" for the CPU). `generator` seeds the init."""

    def __init__(self, num_classes: int = 10, dropout_rate: float = 0.5, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.num_classes = num_classes
        self.dropout_rate = dropout_rate
        self.conv1 = nn.Conv2d(1, 10, 5, device=device)
        self.conv2 = nn.Conv2d(10, 20, 5, device=device)
        self.fc1 = nn.Linear(320, 50, device=device)
        self.fc2 = nn.Linear(50, num_classes, device=device)
        self.reset_parameters(generator)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        for layer in (self.conv1, self.conv2, self.fc1, self.fc2):
            lecun_normal_(layer.weight, layer.weight[0].numel(), generator)
            with torch.no_grad():
                layer.bias.zero_()

    def dropout_shapes(self, batch: int) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
        """The shapes of the two dropout masks for a batch of `batch`."""
        return (batch, 20, 8, 8), (batch, 50)

    def dropout_masks(self, batch: int, generator: torch.Generator):
        """Keep masks for both dropouts of a batch, drawn from `generator`
        on its device: True where an entry survives."""
        keep = 1.0 - self.dropout_rate
        return tuple(torch.rand(s, device=generator.device, generator=generator) < keep
                     for s in self.dropout_shapes(batch))

    def forward(self, x: torch.Tensor, masks=None, generator=None) -> torch.Tensor:
        """`masks` (from `dropout_masks`) turns dropout on with those masks;
        `generator` turns it on with masks drawn from it; with neither,
        dropout is off."""
        if masks is None and generator is not None:
            masks = self.dropout_masks(x.shape[0], generator)
        x = F.relu(max_pool_2x2(self.conv1(x)))
        x = self.conv2(x)
        if masks is not None:
            x = _dropout(x, masks[0], self.dropout_rate)
        x = F.relu(max_pool_2x2(x))
        x = x.flatten(1)  # (B, 320) in (c, h, w) order
        x = F.relu(self.fc1(x))
        if masks is not None:
            x = _dropout(x, masks[1], self.dropout_rate)
        return self.fc2(x)
