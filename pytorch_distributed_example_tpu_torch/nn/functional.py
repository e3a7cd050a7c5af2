"""Differentiable collectives over rank-stacked tensors, in driver mode.

The port of the reference's `nn/functional.py` (after torch's
`torch/distributed/nn/functional.py`). There each function is an
axis-name collective under `shard_map`, and XLA's transpose rules give its
gradient. Here the ranks of a mesh are the leading dims of one tensor on
one device, named by `axes` (default: just `axis_name`), and each function
is a `torch.autograd.Function` that folds over the dim of `axis_name`.
Dims such as `axis`, `split_axis` and `concat_axis` count from the first
dim after the rank dims, as the reference's count a rank's local dims.
Each keeps the reference's value/gradient table:

  value                          gradient (torch semantics)
  all_reduce(SUM):  y = sum_j x_j          dx_j = sum_i ct_i   (all_reduce)
  all_gather:       y = concat_j x_j       dx_j = sum_i ct_i[j] (reduce_scatter)
  reduce_scatter:   y_i = (sum_j x_j)[i]   dx_j = concat_i ct_i (all_gather)
  broadcast(src):   y_i = x_src            dx_src = sum_i ct_i, else 0
  all_to_all:       transpose of shards    inverse all_to_all
  all_to_all_single: single-tensor chunk exchange (same transpose)
  reduce(dst):      dst gets sum_j x_j, rest keep x_j  dx_j = ct_dst (broadcast)
  gather(dst):      dst gets concat_j x_j  dx_j = ct[j] (scatter from dst)
  scatter(src):     y_i = x_src[i]         dx_src = concat_i ct_i (gather)

`replica=True` (all_reduce, all_gather) returns the value every rank of the
axis holds once, without the axis's dim, for a consumer that folds those
ranks into its own rows (a matmul over the rows of every rank): that
consumer's gradient already sums the ranks' cotangents, so the backward
hands each rank the cotangent (all_reduce: Megatron's g operator) or its
slice of it (all_gather: the scatter half of FSDP's reduce_scatter). Its
partner `replicate` gives every rank of the axis a replica and all-reduces
the cotangents back (Megatron's f operator). No W copies are made.

The eager collectives of `distributed.py` stay non-differentiable, as in
the reference and in torch.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from ..types import ReduceOp, _PremulSum, fold

_LINEAR = (ReduceOp.SUM, ReduceOp.AVG, ReduceOp.PREMUL_SUM)


def _resolve_op(op):
    if isinstance(op, str):
        return ReduceOp[op.upper()]
    return op


def _rank_dim(x, axis_name: str, axes: Optional[Sequence[str]]) -> Tuple[int, int, int]:
    """(dim of `axis_name`'s ranks in x, number of rank dims, axis size)."""
    axes = tuple(axes) if axes is not None else (axis_name,)
    if axis_name not in axes:
        raise ValueError(f"axis {axis_name!r} is not one of the rank dims {axes}")
    if x.dim() < len(axes):
        raise ValueError(f"a tensor of {x.dim()} dims cannot hold the rank dims {axes}")
    s = axes.index(axis_name)
    return s, len(axes), x.shape[s]


def _local(dim: int, ndim: int, nstack: int) -> int:
    """A rank's local dim `dim` as a dim of the stacked tensor."""
    local_ndim = ndim - nstack
    if not -local_ndim <= dim < local_ndim:
        raise ValueError(f"dim {dim} out of range for {local_ndim} local dims")
    return nstack + dim % local_ndim


def _linear_factor(op, W: int) -> float:
    if isinstance(op, _PremulSum):
        return float(op.factor)
    return 1.0 / W if op == ReduceOp.AVG else 1.0


def _expand_at(y, s: int, W: int):
    """y (no dim s) -> W identical rows at dim s, as one tensor."""
    return y.unsqueeze(s).expand(*y.shape[:s], W, *y.shape[s:]).contiguous()


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, s, op, replica):
        W = x.shape[s]
        ctx.s, ctx.W, ctx.replica = s, W, replica
        ctx.factor = _linear_factor(op, W)
        ctx.dtype = x.dtype
        y = fold(op)(x.movedim(s, 0))
        return y if replica else _expand_at(y, s, W)

    @staticmethod
    def backward(ctx, ct):
        s, W = ctx.s, ctx.W
        if ctx.replica:  # every rank's cotangent is the replica's
            g = ct.unsqueeze(s).expand(*ct.shape[:s], W, *ct.shape[s:])
        else:  # an all_reduce of the cotangents
            g = ct.sum(s, keepdim=True).expand(ct.shape)
        if ctx.factor != 1.0:
            g = g * ctx.factor
        return g.to(ctx.dtype), None, None, None


def all_reduce(x, op=ReduceOp.SUM, axis_name: str = "dp", axes=None, replica: bool = False):
    """Differentiable all_reduce over the ranks of `axis_name`.

    SUM, AVG and PREMUL_SUM are linear: the backward is an all_reduce of
    the cotangent (with `replica=True`, each rank takes the cotangent).
    MAX and MIN give the value only: the result carries no gradient, as
    the reference's pmax/pmin route does not. PRODUCT is differentiable
    through the reference's log-abs-exp form (zero where any factor is)."""
    op = _resolve_op(op)
    s, nstack, W = _rank_dim(x, axis_name, axes)
    if op in _LINEAR or isinstance(op, _PremulSum):
        return _AllReduce.apply(x, s, op, replica)
    if op == ReduceOp.PRODUCT:
        zero = x == 0
        any_zero = zero.any(s)
        safe = torch.where(zero, torch.ones_like(x), x)
        negatives = (safe < 0).sum(s) % 2
        mag = torch.log(safe.abs()).sum(s)
        prod = torch.where(negatives == 1, -1.0, 1.0).to(x.dtype) * torch.exp(mag)
        y = torch.where(any_zero, torch.zeros_like(prod), prod)
        return y if replica else y.unsqueeze(s).expand(x.shape)
    if op in (ReduceOp.MAX, ReduceOp.MIN):
        y = fold(op)(x.detach().movedim(s, 0))
        return y if replica else _expand_at(y, s, W)
    raise ValueError(f"unsupported differentiable reduce op {op}")


def _concat_ranks(x, s, d, tiled):
    """The ranks' blocks of dim s joined along stacked dim d (the rank dim
    removed): concatenated (tiled) or stacked as a new dim."""
    parts = x.unbind(s)
    return torch.cat(parts, d - 1) if tiled else torch.stack(parts, d - 1)


def _split_ranks(y, s, d, W, tiled):
    """Inverse of `_concat_ranks`: rank j's block of y, stacked at dim s."""
    parts = y.chunk(W, d - 1) if tiled else y.unbind(d - 1)
    return torch.stack(parts, s)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, s, d, tiled, replica):
        W = x.shape[s]
        ctx.args = (s, d, W, tiled, replica)
        if tiled and x.shape[d] == 0:
            raise ValueError("all_gather of an empty dim")
        y = _concat_ranks(x, s, d, tiled)
        return y if replica else _expand_at(y, s, W)

    @staticmethod
    def backward(ctx, ct):
        s, d, W, tiled, replica = ctx.args
        if not replica:
            ct = ct.sum(s)  # the reduce of reduce_scatter
        return _split_ranks(ct, s, d, W, tiled), None, None, None, None


def all_gather(x, axis_name: str = "dp", axis: int = 0, tiled: bool = True, axes=None,
               replica: bool = False):
    """Differentiable all_gather: every rank gets the ranks' blocks joined
    along local dim `axis` (tiled=True, torch's flat layout) or stacked as
    a new local dim there (tiled=False). Backward: reduce_scatter."""
    s, nstack, W = _rank_dim(x, axis_name, axes)
    if tiled:
        d = _local(axis, x.dim(), nstack)
    else:  # the new local dim sits at `axis` of the output
        d = nstack + axis % (x.dim() - nstack + 1)
    return _AllGather.apply(x, s, d, tiled, replica)


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, s, d):
        W = x.shape[s]
        if x.shape[d] % W:
            raise ValueError(f"reduce_scatter: dim of size {x.shape[d]} does not split "
                             f"{W} ways")
        ctx.args = (s, d, W)
        return _split_ranks(fold(ReduceOp.SUM)(x.movedim(s, 0)), s, d, W, True)

    @staticmethod
    def backward(ctx, ct):
        s, d, W = ctx.args
        return _expand_at(_concat_ranks(ct, s, d, True), s, W), None, None


def reduce_scatter(x, axis_name: str = "dp", axis: int = 0, axes=None):
    """Differentiable reduce_scatter(SUM): rank i gets the i-th block of the
    ranks' sum along local dim `axis`. Backward: all_gather."""
    s, nstack, _ = _rank_dim(x, axis_name, axes)
    return _ReduceScatter.apply(x, s, _local(axis, x.dim(), nstack))


def _exchange(x, s, sd, cd, W):
    """Rank j receives block j of every rank's dim sd, joined along cd in
    the order of the sending ranks."""
    rows = [torch.cat([src.chunk(W, sd - 1)[j] for src in x.unbind(s)], cd - 1)
            for j in range(W)]
    return torch.stack(rows, s)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, s, sd, cd):
        W = x.shape[s]
        if x.shape[sd] % W:
            raise ValueError(f"all_to_all: dim of size {x.shape[sd]} does not split {W} ways")
        ctx.args = (s, sd, cd, W)
        return _exchange(x, s, sd, cd, W)

    @staticmethod
    def backward(ctx, ct):
        s, sd, cd, W = ctx.args
        return _exchange(ct, s, cd, sd, W), None, None, None


def all_to_all(x, axis_name: str = "dp", split_axis: int = 0, concat_axis: int = 0, axes=None):
    """Differentiable all_to_all: each rank splits local dim `split_axis`
    W ways, block j goes to rank j, and each rank joins what it receives
    along `concat_axis`. Backward: the inverse all_to_all."""
    s, nstack, _ = _rank_dim(x, axis_name, axes)
    return _AllToAll.apply(x, s, _local(split_axis, x.dim(), nstack),
                           _local(concat_axis, x.dim(), nstack))


def all_to_all_single(x, axis_name: str = "dp", split_axis: int = 0, concat_axis: int = 0,
                      axes=None):
    """torch `nn.functional.all_to_all_single` on the single-tensor layout,
    even splits only (uneven ones live in the eager
    `distributed.all_to_all_single`)."""
    s, nstack, W = _rank_dim(x, axis_name, axes)
    size = x.shape[_local(split_axis, x.dim(), nstack)]
    if size % W:
        raise ValueError(
            f"all_to_all_single: dim {split_axis} of size {size} not divisible by axis "
            f"{axis_name!r} size {W}; pad upstream (uneven splits live in the eager "
            "distributed.all_to_all_single)")
    return all_to_all(x, axis_name, split_axis, concat_axis, axes)


class _Broadcast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, s, src):
        ctx.args = (s, src, x.shape)
        return _expand_at(x.select(s, src), s, x.shape[s])

    @staticmethod
    def backward(ctx, ct):
        s, src, shape = ctx.args
        g = ct.new_zeros(shape)
        g.select(s, src).copy_(ct.sum(s))
        return g, None, None


def broadcast(x, src: int = 0, axis_name: str = "dp", axes=None):
    """Differentiable broadcast: every rank gets rank `src`'s value. The
    summed cotangent lands at `src`, zero elsewhere (torch's
    `_Broadcast.backward`)."""
    s, _, W = _rank_dim(x, axis_name, axes)
    if not 0 <= src < W:
        raise ValueError(f"src {src} out of range for axis {axis_name!r} of size {W}")
    return _Broadcast.apply(x, s, src)


def _only_at(y, s, rank):
    """y with every row of dim s but `rank`'s zeroed."""
    mask = torch.zeros(y.shape[s], dtype=y.dtype, device=y.device)
    mask[rank] = 1
    return y * mask.reshape((-1,) + (1,) * (y.dim() - s - 1))


def gather(x, dst: int = 0, axis_name: str = "dp", axis: int = 0, axes=None):
    """Differentiable gather: rank `dst` gets the concatenation along local
    dim `axis`, the other ranks zeros (one shape on every rank, as the
    reference's). Backward: each rank's slice of dst's cotangent."""
    return _only_at(all_gather(x, axis_name, axis, True, axes), _rank_dim(x, axis_name, axes)[0],
                    dst)


def scatter(x, src: int = 0, axis_name: str = "dp", axis: int = 0, axes=None):
    """Differentiable scatter: rank i gets block i of rank `src`'s local dim
    `axis`. Backward: the cotangents gathered at `src`."""
    s, nstack, W = _rank_dim(x, axis_name, axes)
    d = _local(axis, x.dim(), nstack)
    if x.shape[d] % W:
        raise ValueError(f"scatter: dim {axis} of size {x.shape[d]} not divisible by axis "
                         f"{axis_name!r} size {W}")
    full = broadcast(x, src, axis_name, axes)
    n = x.shape[d] // W
    return torch.stack([full.select(s, i).narrow(d - 1, i * n, n) for i in range(W)], s)


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, s, dst, op):
        W = x.shape[s]
        ctx.args = (s, dst, W)
        out = x.clone()
        out.select(s, dst).copy_(fold(op)(x.movedim(s, 0)).to(x.dtype))
        return out

    @staticmethod
    def backward(ctx, ct):
        s, dst, W = ctx.args
        return _expand_at(ct.select(s, dst), s, W), None, None, None


def reduce(x, dst: int = 0, op=ReduceOp.SUM, axis_name: str = "dp", axes=None):
    """Differentiable reduce-to-dst (torch `_Reduce`): rank `dst` gets the
    reduction, every other rank its input back. Whatever the op, the
    backward hands every rank dst's cotangent; the others' are dropped."""
    s, _, W = _rank_dim(x, axis_name, axes)
    return _Reduce.apply(x, s, dst, _resolve_op(op))


class _Replicate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, s, W):
        ctx.s = s
        return x.unsqueeze(s).expand(*x.shape[:s], W, *x.shape[s:])

    @staticmethod
    def backward(ctx, ct):
        return ct.sum(ctx.s), None, None


def replicate(x, axis_name: str, size: int, axes=None):
    """Megatron's f operator: every rank of `axis_name` takes the replica
    `x` (a view, dim `axes.index(axis_name)` of `size` rows); the backward
    all-reduces the ranks' cotangents into the replica's."""
    axes = tuple(axes) if axes is not None else (axis_name,)
    return _Replicate.apply(x, axes.index(axis_name), size)
