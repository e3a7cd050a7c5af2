"""ResNet for CIFAR, the port of the reference's `models/resnet.py`
(`BASELINE.json` config #3: ResNet-18 on CIFAR-10 under 8-rank DDP).

The CIFAR variant: a 3x3 stem (no 7x7, no max pool), `BasicBlock` or
`Bottleneck` stages, a global average pool and a dense head; the logits
come out float32. It takes the reference's NHWC batch and runs NCHW with
channels_last strides inside (the permute is that layout's view).

Where it follows the reference rather than torchvision:
  - convolutions pad "SAME" as flax does: a 3x3 stride-2 conv on an even
    size pads 0 before and 1 after (torch's `padding=1` would pad 1 and 1);
  - the norm is flax's `BatchNorm`, written here, not `nn.BatchNorm2d`:
    statistics in float32, the variance E[x^2] - E[x]^2 clipped at 0, the
    biased batch variance into the running variance, momentum 0.9 as
    ``ra = 0.9 ra + 0.1 batch``, eps 1e-5, y = (x - mean) * (rsqrt(var +
    eps) * scale) + bias in that order, cast to the compute dtype; the
    second norm of each block starts with a zero scale;
  - `dtype` (float32 or bfloat16) is the compute dtype of convolutions,
    norms' outputs and the head, the params stay float32, as flax's
    `dtype=`; the init is flax's (`lecun_normal` kernels, zero biases).

Training is functional, as flax's `mutable=["batch_stats"]`:
`model(x, train=True)` returns `(logits, new_stats)`, `new_stats` the
updated running buffers keyed by their state-dict names, and leaves the
module's buffers alone, so it runs under `torch.func.functional_call`,
`grad` and `vmap`. `model(x)` evaluates with the running buffers.

SyncBatchNorm (`convert_sync_batchnorm`): in driver mode the train step
vmaps each rank's forward over the rank dim, and every norm's batch
statistics (mean, mean of squares) are averaged over that dim by
`nn.functional.all_reduce` (the port's c10d fold) inside a
`torch.autograd.Function` whose `vmap` rule sees all ranks at once; its
backward averages the cotangents over the ranks the same way, the
transpose of the reference's `pmean` under `shard_map`. In multiproc mode
the step enters `DeviceMesh.from_group(group, "_ranks")` around its rank
vmap, which holds this process's one rank, and the same rule all-reduces
the statistics (and, in the backward, the cotangents) over that group,
inside the forward.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..nn import functional as dfn
from ..types import ReduceOp
from .convnet import lecun_normal_
from .transformer import resolve_device

_SYNC_AXIS = dfn.RANKS


class _RankMean(torch.autograd.Function):
    """The mean over the ranks of the step's rank vmap. Its `vmap` rule
    folds the rank dim through `nn.functional.all_reduce` (the fold in
    driver mode, the step's group's all_reduce in multiproc mode); its
    backward is itself (the transpose of a mean over ranks)."""

    @staticmethod
    def forward(x):
        raise RuntimeError(
            "sync batch norm reduces over the ranks of a rank-vmapped train step "
            "(examples/cifar.py's); call the model without a sync axis elsewhere")

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, ct):
        return _RankMean.apply(ct)

    @staticmethod
    def vmap(info, in_dims, x):
        if in_dims[0] is None:  # the same on every rank
            return x, None
        x = x.movedim(in_dims[0], 0)
        return dfn.all_reduce(x, ReduceOp.AVG, axis_name=_SYNC_AXIS), 0


def _same_pad(size: int, k: int, s: int) -> Tuple[int, int]:
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


class Conv(nn.Module):
    """flax `nn.Conv(use_bias=False)` with "SAME" padding over NCHW."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.k, self.stride, self.dtype = k, stride, dtype
        self.weight = nn.Parameter(torch.empty(cout, cin, k, k, device=device))

    def reset_parameters(self, generator=None):
        lecun_normal_(self.weight, self.weight[0].numel(), generator)

    def forward(self, x):
        ph = _same_pad(x.shape[2], self.k, self.stride)
        pw = _same_pad(x.shape[3], self.k, self.stride)
        x = x.to(self.dtype)
        if ph[0] == ph[1] and pw[0] == pw[1]:
            return F.conv2d(x, self.weight.to(self.dtype), stride=self.stride,
                            padding=(ph[0], pw[0]))
        x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
        return F.conv2d(x, self.weight.to(self.dtype), stride=self.stride)


class BatchNorm(nn.Module):
    """flax `nn.BatchNorm` over the channels of NCHW (see the module
    docstring); `axis_name` set makes it a SyncBatchNorm over the ranks."""

    def __init__(self, channels: int, zero_scale: bool = False, momentum: float = 0.9,
                 eps: float = 1e-5, dtype=torch.float32, device=None):
        super().__init__()
        self.momentum, self.eps, self.dtype = momentum, eps, dtype
        self.zero_scale = zero_scale
        self.axis_name: Optional[str] = None
        self._path = ""  # its state-dict prefix inside a model (set by ResNet)
        self.weight = nn.Parameter(torch.empty(channels, device=device))
        self.bias = nn.Parameter(torch.empty(channels, device=device))
        self.register_buffer("running_mean", torch.zeros(channels, device=device))
        self.register_buffer("running_var", torch.ones(channels, device=device))
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        with torch.no_grad():
            self.weight.fill_(0.0 if self.zero_scale else 1.0)
            self.bias.zero_()

    def forward(self, x, new: Optional[dict] = None):
        """Normalize x (N, C, H, W). With `new` (a dict) it trains: batch
        statistics, and the updated running buffers written into `new`."""
        if new is None:
            mean, var = self.running_mean, self.running_var
        else:
            x32 = x.float()
            stats = torch.stack([x32.mean((0, 2, 3)), (x32 * x32).mean((0, 2, 3))])
            if self.axis_name is not None:
                stats = _RankMean.apply(stats)
            mean, mean2 = stats[0], stats[1]
            var = torch.clamp_min(mean2 - mean * mean, 0.0)
            m = self.momentum
            new[self._path + "running_mean"] = m * self.running_mean + (1 - m) * mean
            new[self._path + "running_var"] = m * self.running_var + (1 - m) * var
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (x - mean[:, None, None]) * mul[:, None, None] + self.bias[:, None, None]
        return y.to(self.dtype)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, cin: int, filters: int, stride: int = 1, dtype=torch.float32,
                 device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.conv0 = Conv(cin, filters, 3, stride, **kw)
        self.bn0 = BatchNorm(filters, **kw)
        self.conv1 = Conv(filters, filters, 3, 1, **kw)
        self.bn1 = BatchNorm(filters, zero_scale=True, **kw)
        self.proj = stride != 1 or cin != filters
        if self.proj:
            self.conv_proj = Conv(cin, filters, 1, stride, **kw)
            self.norm_proj = BatchNorm(filters, **kw)

    def forward(self, x, new=None):
        y = F.relu(self.bn0(self.conv0(x), new))
        y = self.bn1(self.conv1(y), new)
        res = self.norm_proj(self.conv_proj(x), new) if self.proj else x
        return F.relu(res + y)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, cin: int, filters: int, stride: int = 1, dtype=torch.float32,
                 device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.conv0 = Conv(cin, filters, 1, 1, **kw)
        self.bn0 = BatchNorm(filters, **kw)
        self.conv1 = Conv(filters, filters, 3, stride, **kw)
        self.bn1 = BatchNorm(filters, **kw)
        self.conv2 = Conv(filters, filters * 4, 1, 1, **kw)
        self.bn2 = BatchNorm(filters * 4, zero_scale=True, **kw)
        self.proj = stride != 1 or cin != filters * 4
        if self.proj:
            self.conv_proj = Conv(cin, filters * 4, 1, stride, **kw)
            self.norm_proj = BatchNorm(filters * 4, **kw)

    def forward(self, x, new=None):
        y = F.relu(self.bn0(self.conv0(x), new))
        y = F.relu(self.bn1(self.conv1(y), new))
        y = self.bn2(self.conv2(y), new)
        res = self.norm_proj(self.conv_proj(x), new) if self.proj else x
        return F.relu(res + y)


class ResNet(nn.Module):
    """images (B, 32, 32, 3) NHWC -> logits (B, num_classes) float32.

    Built on `device`, cuda:0 by default (it raises without a card; pass
    device="cpu" for the CPU). `generator` seeds the init."""

    def __init__(self, stage_sizes: Sequence[int], block_cls=BasicBlock, num_classes: int = 10,
                 num_filters: int = 64, dtype=torch.float32, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.stage_sizes = list(stage_sizes)
        self.block_cls = block_cls
        self.num_classes, self.num_filters, self.dtype = num_classes, num_filters, dtype
        kw = dict(dtype=dtype, device=device)
        self.conv_init = Conv(3, num_filters, 3, 1, **kw)
        self.bn_init = BatchNorm(num_filters, **kw)
        blocks: List[nn.Module] = []
        cin = num_filters
        for i, count in enumerate(self.stage_sizes):
            for j in range(count):
                stride = 2 if i > 0 and j == 0 else 1
                blocks.append(block_cls(cin, num_filters * 2 ** i, stride, **kw))
                cin = num_filters * 2 ** i * block_cls.expansion
        self.blocks = nn.ModuleList(blocks)
        self.fc = nn.Linear(cin, num_classes, device=device)
        for name, m in self.named_modules():
            if isinstance(m, BatchNorm):
                m._path = name + "."
        self.reset_parameters(generator)

    @property
    def bn_axis_name(self) -> Optional[str]:
        return self.bn_init.axis_name

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        for m in self.modules():
            if isinstance(m, (Conv, BatchNorm)):
                m.reset_parameters(generator)
        lecun_normal_(self.fc.weight, self.fc.weight.shape[1], generator)
        with torch.no_grad():
            self.fc.bias.zero_()

    def forward(self, x: torch.Tensor, train: bool = False):
        new = {} if train else None
        x = x.permute(0, 3, 1, 2)  # NHWC -> NCHW, channels_last strides
        x = F.relu(self.bn_init(self.conv_init(x), new))
        for block in self.blocks:
            x = block(x, new)
        x = x.mean(dim=(2, 3))  # global average pool
        logits = F.linear(x.to(self.dtype), self.fc.weight.to(self.dtype),
                          self.fc.bias.to(self.dtype)).float()
        return (logits, new) if train else logits

    def params_and_stats(self):
        """({name: param}, {name: running buffer}), detached."""
        return ({n: p.detach() for n, p in self.named_parameters()},
                {n: b.detach() for n, b in self.named_buffers()})

    def hook_views(self):
        """The params in the reference's flattened order and layout, for
        per-leaf comm hooks (`parallel/ddp.py`)."""
        from .convert import resnet_hook_views

        return resnet_hook_views(self)


def convert_sync_batchnorm(model: ResNet, axis_name: str = _SYNC_AXIS) -> ResNet:
    """torch's `SyncBatchNorm.convert_sync_batchnorm(model)`: every norm of
    `model` (in place, returned) averages its batch statistics over the
    ranks of the rank-vmapped train step. `axis_name` is the reference's
    name of that axis and only labels it here; None turns the sync off."""
    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.axis_name = axis_name
    return model


def ResNet18(**kw) -> ResNet:
    return ResNet(stage_sizes=[2, 2, 2, 2], block_cls=BasicBlock, **kw)


def ResNet34(**kw) -> ResNet:
    return ResNet(stage_sizes=[3, 4, 6, 3], block_cls=BasicBlock, **kw)


def ResNet50(**kw) -> ResNet:
    return ResNet(stage_sizes=[3, 4, 6, 3], block_cls=Bottleneck, **kw)


