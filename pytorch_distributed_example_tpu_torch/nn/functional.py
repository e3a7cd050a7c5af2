"""Differentiable collectives over rank-stacked tensors, in both modes.

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

**Multiproc mode.** Inside an entered multiproc mesh (`with mesh:`,
`mesh.py`) whose axes include `axis_name`, this process holds one row of
that axis, a rank dim of size 1, and each function is the same table
over the processes: the fold becomes a collective of the axis's process
group through the c10d core (`distributed.py`, `backends/process.py`),
wrapped by the same autograd `Function`s, whose backward runs the
transposed collective: each Function is written once over an axis's
ranks, `_Fold` (driver mode) or `_Proc` (multiproc), which hold the
modes' primitives. A process is a rank's row: a replica is held by
every process of the axis, and its backward hands the process its own
cotangent (or its slice), so the consumers of a replica must compute the
same thing on every process (Megatron's tp ranks); where they differ
(data ranks), the non-replica form sums their cotangents. The group is
resolved when the forward runs and kept for the backward. `ppermute`
(the reference's `lax.ppermute`) moves rows along the axis; in multiproc
mode every process issues the same isend/irecv pairs, a rank with
nothing to send or receive too.

The eager collectives of `distributed.py` stay non-differentiable, as in
the reference and in torch.

Each collective's forward records itself, before it runs, to the program
plane's taps (`schedule.tap`, `tools/proglint.py`) with one rank's shape;
with no tap installed that is one test of an empty list.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from .. import mesh as _mesh
from .. import schedule as _schedule
from ..types import ReduceOp, _PremulSum, fold

_LINEAR = (ReduceOp.SUM, ReduceOp.AVG, ReduceOp.PREMUL_SUM)
# the axis of a rank-vmapped step's ranks (the DDP step's): in multiproc
# mode the step enters `DeviceMesh.from_group(group, RANKS)`
RANKS = "_ranks"


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


def _parts(t, W: int, d: int, tiled: bool):
    """t's W blocks along dim d (tiled), or its W slices of dim d."""
    return t.chunk(W, d) if tiled else t.unbind(d)


def _joined(blocks, d: int, tiled: bool):
    """The blocks (W, *blk) joined along dim d: `_parts`'s inverse."""
    return torch.cat(blocks.unbind(0), d) if tiled else torch.stack(blocks.unbind(0), d)


# ---------------------------------------------------------------------------
# an axis's ranks, by mode: the primitives the Functions below are made of
# ---------------------------------------------------------------------------


class _Fold:
    """Driver mode: the axis's W ranks are dim s of one tensor on this
    device, and each primitive folds over that dim."""

    b = None

    def __init__(self, size: int):
        self.size = size

    def total(self, x, s: int, op=None):
        """The ranks' reduction of x (without dim s): `fold(op)`, or
        torch's sum where op is None (the backwards' form)."""
        return x.sum(s) if op is None else fold(op)(x.movedim(s, 0))

    def rows(self, x, s: int):
        """Every rank's row of x, stacked at dim 0."""
        return x.movedim(s, 0)

    def pick(self, x, s: int, src: int):
        """Rank src's row of x (without dim s), as every rank gets it."""
        return x.select(s, src)

    def spread(self, y, s: int):
        """y (no dim s) as every rank's, one tensor."""
        return _expand_at(y, s, self.size)

    def each(self, y, s: int):
        """y (no dim s) as every rank's, a view."""
        return y.unsqueeze(s).expand(*y.shape[:s], self.size, *y.shape[s:])

    def own(self, parts, s: int):
        """Rank j takes parts[j]."""
        return torch.stack(parts, s)

    def put(self, out, s: int, rank: int, v):
        """out with rank `rank`'s row set to v."""
        out.select(s, rank).copy_(v)
        return out

    def scatter_total(self, x, s: int, d: int, tiled: bool, op=None):
        """Rank j's block j (of dim d of x) of the ranks' `total`."""
        return self.own(_parts(self.total(x, s, op), self.size, d - 1, tiled), s)

    def exchange(self, x, s: int, sd: int, cd: int):
        """Rank j receives block j of every rank's dim sd, joined along cd
        in the order of the sending ranks."""
        W = self.size
        rows = [torch.cat([src.chunk(W, sd - 1)[j] for src in x.unbind(s)], cd - 1)
                for j in range(W)]
        return torch.stack(rows, s)


class _Proc:
    """Multiproc mode: this process holds one row of the axis (dim s of
    size 1), rank `b.index`; each primitive is a collective of the axis's
    group through the c10d core, outside autograd."""

    def __init__(self, b):
        self.b, self.size = b, b.size

    def total(self, x, s: int, op=None):
        return _core("all_reduce", x.select(s, 0), self.b, ReduceOp.SUM if op is None else op)

    def rows(self, x, s: int):
        return _core("all_gather", x.select(s, 0), self.b)

    def pick(self, x, s: int, src: int):
        return _core("broadcast", x.select(s, 0), self.b, src)

    def spread(self, y, s: int):
        return y.unsqueeze(s)

    each = spread

    def own(self, parts, s: int):
        return parts[self.b.index].unsqueeze(s)

    def put(self, out, s: int, rank: int, v):
        return v.unsqueeze(s) if self.b.index == rank else out

    def scatter_total(self, x, s: int, d: int, tiled: bool, op=None):
        blocks = torch.stack(_parts(x.select(s, 0), self.size, d - 1, tiled))
        return _core("reduce_scatter", blocks, self.b, ReduceOp.SUM).unsqueeze(s)

    def exchange(self, x, s: int, sd: int, cd: int):
        blocks = torch.stack(x.select(s, 0).chunk(self.size, sd - 1))
        return _joined(_core("all_to_all", blocks, self.b), cd - 1, True).unsqueeze(s)


def _core(name, t, b, *args):
    """One collective of the c10d core over b's group on this process's
    row `t`: the result row (a tensor), outside autograd. The axis
    collective that lowers here has recorded itself for the program
    plane (`_tap`), so its c10d dispatch is hidden from the taps."""
    from .. import distributed as dist
    from ..tensor import DistTensor

    dt = DistTensor(t.detach().contiguous().unsqueeze(0), b.group)
    if _schedule._taps:
        with _schedule.taps_muted():
            out = getattr(dist, name)(dt, *args, group=b.group)
    else:
        out = getattr(dist, name)(dt, *args, group=b.group)
    return (dt if out is None else out).tensor[0]


def _tap(op: str, x, axis_name: str, nstack: int, **params) -> None:
    """The program plane's seam (`schedule.tap`): one axis collective, with
    one rank's shape (x without its rank dims), before it runs. Callers
    test `_schedule._taps` first, so an untapped collective builds no
    record."""
    _schedule.tap_record("axis", op, (axis_name,), x.shape[nstack:],
                         str(x.dtype).removeprefix("torch."), params)


def _ranks(axis_name: str, x, s: int):
    """The ranks of `axis_name` as x holds them at dim s: the entered
    multiproc mesh's binding (one row a process), else the fold."""
    b = _mesh.axis_binding(axis_name)
    if b is None:
        return _Fold(x.shape[s])
    if x.shape[s] != 1:
        raise ValueError(f"multiproc mode: a process holds one row of axis {axis_name!r}, "
                         f"got {x.shape[s]} at dim {s}")
    return _Proc(b)


# ---------------------------------------------------------------------------
# the differentiable collectives
# ---------------------------------------------------------------------------


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, s, op, replica, R):
        ctx.s, ctx.R, ctx.replica = s, R, replica
        ctx.factor = _linear_factor(op, R.size)
        ctx.dtype = x.dtype
        y = R.total(x, s, op)
        return y if replica else R.spread(y, s)

    @staticmethod
    def backward(ctx, ct):
        s, R = ctx.s, ctx.R
        if ctx.replica:  # every rank's cotangent is the replica's
            g = R.each(ct, s)
        else:  # an all_reduce of the cotangents
            g = R.each(R.total(ct, s), s)
        if ctx.factor != 1.0:
            g = g * ctx.factor
        return g.to(ctx.dtype), None, None, None, None


def all_reduce(x, op=ReduceOp.SUM, axis_name: str = "dp", axes=None, replica: bool = False):
    """Differentiable all_reduce over the ranks of `axis_name`.

    SUM, AVG and PREMUL_SUM are linear: the backward is an all_reduce of
    the cotangent (with `replica=True`, each rank takes the cotangent).
    MAX and MIN give the value only: the result carries no gradient, as
    the reference's pmax/pmin route does not. PRODUCT is differentiable
    through the reference's log-abs-exp form (zero where any factor is)."""
    op = _resolve_op(op)
    s, nstack, W = _rank_dim(x, axis_name, axes)
    R = _ranks(axis_name, x, s)
    if _schedule._taps:
        _tap("all_reduce", x, axis_name, nstack, reduce_op=str(op))
    if op in _LINEAR or isinstance(op, _PremulSum):
        return _AllReduce.apply(x, s, op, replica, R)
    if op == ReduceOp.PRODUCT:
        zero = x == 0
        any_zero = R.total(zero.to(torch.int32), s, ReduceOp.MAX) > 0
        safe = torch.where(zero, torch.ones_like(x), x)
        negatives = R.total((safe < 0).to(torch.int32), s, ReduceOp.SUM) % 2
        logs = torch.log(safe.abs())
        mag = logs.sum(s) if R.b is None else _AllReduce.apply(logs, s, ReduceOp.SUM, True, R)
        prod = torch.where(negatives == 1, -1.0, 1.0).to(x.dtype) * torch.exp(mag)
        y = torch.where(any_zero, torch.zeros_like(prod), prod)
        return y if replica else _Replicate.apply(y, s, R)
    if op in (ReduceOp.MAX, ReduceOp.MIN):
        y = R.total(x.detach(), s, op)
        return y if replica else R.spread(y, s)
    raise ValueError(f"unsupported differentiable reduce op {op}")


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, s, d, tiled, replica, R):
        ctx.args = (s, d, tiled, replica, R)
        if tiled and x.shape[d] == 0:
            raise ValueError("all_gather of an empty dim")
        y = _joined(R.rows(x, s), d - 1, tiled)
        return y if replica else R.spread(y, s)

    @staticmethod
    def backward(ctx, ct):
        s, d, tiled, replica, R = ctx.args
        if replica:  # each rank's slice of the replica's cotangent
            g = R.own(_parts(ct, R.size, d - 1, tiled), s)
        else:  # reduce_scatter of the ranks' cotangents
            g = R.scatter_total(ct, s, d, tiled)
        return g, None, None, None, None, None


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
    if _schedule._taps:
        _tap("all_gather", x, axis_name, nstack, all_gather_dimension=d - nstack, tiled=tiled)
    return _AllGather.apply(x, s, d, tiled, replica, _ranks(axis_name, x, s))


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, s, d, R):
        if x.shape[d] % R.size:
            raise ValueError(f"reduce_scatter: dim of size {x.shape[d]} does not split "
                             f"{R.size} ways")
        ctx.args = (s, d, R)
        return R.scatter_total(x, s, d, True, ReduceOp.SUM)

    @staticmethod
    def backward(ctx, ct):
        s, d, R = ctx.args
        return R.spread(_joined(R.rows(ct, s), d - 1, True), s), None, None, None


def reduce_scatter(x, axis_name: str = "dp", axis: int = 0, axes=None):
    """Differentiable reduce_scatter(SUM): rank i gets the i-th block of the
    ranks' sum along local dim `axis`. Backward: all_gather."""
    s, nstack, _ = _rank_dim(x, axis_name, axes)
    d = _local(axis, x.dim(), nstack)
    if _schedule._taps:
        _tap("reduce_scatter", x, axis_name, nstack, scatter_dimension=d - nstack, tiled=True)
    return _ReduceScatter.apply(x, s, d, _ranks(axis_name, x, s))


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, s, sd, cd, R):
        if x.shape[sd] % R.size:
            raise ValueError(f"all_to_all: dim of size {x.shape[sd]} does not split "
                             f"{R.size} ways")
        ctx.args = (s, sd, cd, R)
        return R.exchange(x, s, sd, cd)

    @staticmethod
    def backward(ctx, ct):
        s, sd, cd, R = ctx.args
        return R.exchange(ct, s, cd, sd), None, None, None, None


def all_to_all(x, axis_name: str = "dp", split_axis: int = 0, concat_axis: int = 0, axes=None):
    """Differentiable all_to_all: each rank splits local dim `split_axis`
    W ways, block j goes to rank j, and each rank joins what it receives
    along `concat_axis`. Backward: the inverse all_to_all."""
    s, nstack, _ = _rank_dim(x, axis_name, axes)
    sd, cd = _local(split_axis, x.dim(), nstack), _local(concat_axis, x.dim(), nstack)
    if _schedule._taps:
        _tap("all_to_all", x, axis_name, nstack, split_axis=sd - nstack, concat_axis=cd - nstack)
    return _AllToAll.apply(x, s, sd, cd, _ranks(axis_name, x, s))


def all_to_all_single(x, axis_name: str = "dp", split_axis: int = 0, concat_axis: int = 0,
                      axes=None):
    """torch `nn.functional.all_to_all_single` on the single-tensor layout,
    even splits only (uneven ones live in the eager
    `distributed.all_to_all_single`)."""
    s, nstack, _ = _rank_dim(x, axis_name, axes)
    W = _ranks(axis_name, x, s).size
    size = x.shape[_local(split_axis, x.dim(), nstack)]
    if size % W:
        raise ValueError(
            f"all_to_all_single: dim {split_axis} of size {size} not divisible by axis "
            f"{axis_name!r} size {W}; pad upstream (uneven splits live in the eager "
            "distributed.all_to_all_single)")
    return all_to_all(x, axis_name, split_axis, concat_axis, axes)


class _Broadcast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, s, src, R):
        ctx.args = (s, src, x.shape, R)
        return R.spread(R.pick(x, s, src), s)

    @staticmethod
    def backward(ctx, ct):
        s, src, shape, R = ctx.args
        return R.put(ct.new_zeros(shape), s, src, R.total(ct, s)), None, None, None


def broadcast(x, src: int = 0, axis_name: str = "dp", axes=None):
    """Differentiable broadcast: every rank gets rank `src`'s value. The
    summed cotangent lands at `src`, zero elsewhere (torch's
    `_Broadcast.backward`)."""
    s, nstack, _ = _rank_dim(x, axis_name, axes)
    R = _ranks(axis_name, x, s)
    if not 0 <= src < R.size:
        raise ValueError(f"src {src} out of range for axis {axis_name!r} of size {R.size}")
    if _schedule._taps:
        _tap("broadcast", x, axis_name, nstack, src=src)
    return _Broadcast.apply(x, s, src, R)


def _only_at(y, s, rank, b=None):
    """y with every row of dim s but `rank`'s zeroed (multiproc: this
    process's row, unless it is `rank`'s)."""
    mask = torch.zeros(y.shape[s], dtype=y.dtype, device=y.device)
    if b is None:
        mask[rank] = 1
    elif b.index == rank:
        mask[0] = 1
    return y * mask.reshape((-1,) + (1,) * (y.dim() - s - 1))


def gather(x, dst: int = 0, axis_name: str = "dp", axis: int = 0, axes=None):
    """Differentiable gather: rank `dst` gets the concatenation along local
    dim `axis`, the other ranks zeros (one shape on every rank, as the
    reference's). Backward: each rank's slice of dst's cotangent."""
    s = _rank_dim(x, axis_name, axes)[0]
    return _only_at(all_gather(x, axis_name, axis, True, axes), s, dst,
                    _ranks(axis_name, x, s).b)


def scatter(x, src: int = 0, axis_name: str = "dp", axis: int = 0, axes=None):
    """Differentiable scatter: rank i gets block i of rank `src`'s local dim
    `axis`. Backward: the cotangents gathered at `src`."""
    s, nstack, _ = _rank_dim(x, axis_name, axes)
    R = _ranks(axis_name, x, s)
    W, b = R.size, R.b
    d = _local(axis, x.dim(), nstack)
    if x.shape[d] % W:
        raise ValueError(f"scatter: dim {axis} of size {x.shape[d]} not divisible by axis "
                         f"{axis_name!r} size {W}")
    full = broadcast(x, src, axis_name, axes)
    n = x.shape[d] // W
    ranks = range(W) if b is None else (b.index,)
    return torch.stack([full.select(s, 0 if b else i).narrow(d - 1, i * n, n)
                        for i in ranks], s)


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, s, dst, op, R):
        ctx.args = (s, dst, R)
        return R.put(x.clone(), s, dst, R.total(x, s, op).to(x.dtype))

    @staticmethod
    def backward(ctx, ct):
        s, dst, R = ctx.args
        return R.spread(R.pick(ct, s, dst), s), None, None, None, None


def reduce(x, dst: int = 0, op=ReduceOp.SUM, axis_name: str = "dp", axes=None):
    """Differentiable reduce-to-dst (torch `_Reduce`): rank `dst` gets the
    reduction, every other rank its input back. Whatever the op, the
    backward hands every rank dst's cotangent; the others' are dropped."""
    s, nstack, _ = _rank_dim(x, axis_name, axes)
    op = _resolve_op(op)
    if _schedule._taps:
        _tap("reduce", x, axis_name, nstack, dst=dst, reduce_op=str(op))
    return _Reduce.apply(x, s, dst, op, _ranks(axis_name, x, s))


class _Replicate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, s, R):
        ctx.s, ctx.R = s, R
        return R.each(x, s)

    @staticmethod
    def backward(ctx, ct):
        return ctx.R.total(ct, ctx.s), None, None


def replicate(x, axis_name: str, size: int, axes=None):
    """Megatron's f operator: every rank of `axis_name` takes the replica
    `x` (a view, dim `axes.index(axis_name)` of `size` rows); the backward
    all-reduces the ranks' cotangents into the replica's."""
    axes = tuple(axes) if axes is not None else (axis_name,)
    b = _mesh.axis_binding(axis_name)
    return _Replicate.apply(x, axes.index(axis_name), _Fold(size) if b is None else _Proc(b))


class _VmapRankReduce(torch.autograd.Function):
    """The SUM or AVG over the ranks of a rank `vmap` (the DDP step's): a
    rank's value inside the vmapped function, whose `vmap` rule folds the
    rank dim through `all_reduce` above. Outside a vmap, or on a value that
    does not vary over the ranks, there are no ranks to reduce over, and it
    raises."""

    @staticmethod
    def forward(x, op):
        raise RuntimeError(
            "rank_all_reduce reduces over the ranks of a rank-vmapped step "
            "(parallel/ddp.py's); call it inside the loss of such a step")

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.op = inputs[1]

    @staticmethod
    def backward(ctx, ct):
        return _VmapRankReduce.apply(ct, ctx.op), None

    @staticmethod
    def vmap(info, in_dims, x, op):
        x = x.movedim(in_dims[0], 0)
        return all_reduce(x, op, axis_name=RANKS), 0


def rank_all_reduce(x, op=ReduceOp.SUM):
    """SUM or AVG of `x` over the ranks of the rank `vmap` it runs in
    (the reference's `lax.psum(x, axis)` inside its step's `shard_map`).
    Differentiable: the backward reduces the cotangents the same way."""
    op = _resolve_op(op)
    if op not in (ReduceOp.SUM, ReduceOp.AVG):
        raise ValueError(f"rank_all_reduce takes SUM or AVG, not {op}")
    return _VmapRankReduce.apply(x, op)


def rank_ids(axis_name: str, n: int, device=None) -> torch.Tensor:
    """The ranks of `axis_name` whose rows this process holds: all n in
    driver mode, its own in multiproc mode (the reference's
    `lax.axis_index`)."""
    b = _mesh.axis_binding(axis_name)
    if b is None:
        return torch.arange(n, device=device)
    return torch.tensor([b.index], device=device)


def _moved(row, perm, b):
    """This process's row after the pairs of `perm` moved the rows: the
    source's row, or zeros where no pair sends here."""
    out = _core("permute", row, b, list(perm))
    if not any(dst == b.index for _, dst in perm):
        return torch.zeros_like(out)
    return out


class _Permute(torch.autograd.Function):
    """Multiproc `ppermute`: isend/irecv pairs through the c10d core."""

    @staticmethod
    def forward(ctx, x, s, perm, b):
        ctx.args = (s, perm, b)
        return _moved(x.select(s, 0), perm, b).unsqueeze(s)

    @staticmethod
    def backward(ctx, ct):
        s, perm, b = ctx.args
        inverse = tuple((dst, src) for src, dst in perm)
        return _moved(ct.select(s, 0), inverse, b).unsqueeze(s), None, None, None


def ppermute(x, axis_name: str, perm, axes=None):
    """The reference's `lax.ppermute` over the ranks of `axis_name`: for
    each (src, dst) pair, rank dst gets rank src's block; a rank no pair
    sends to gets zeros. Differentiable: the backward moves the
    cotangents by the inverse pairs."""
    s, nstack, _ = _rank_dim(x, axis_name, axes)
    perm = tuple((int(a), int(c)) for a, c in perm)
    if _schedule._taps:
        _tap("ppermute", x, axis_name, nstack, perm=perm)
    b = _ranks(axis_name, x, s).b
    if b is not None:
        return _Permute.apply(x, s, perm, b)
    src = torch.tensor([a for a, _ in perm], device=x.device, dtype=torch.long)
    dst = torch.tensor([c for _, c in perm], device=x.device, dtype=torch.long)
    return torch.zeros_like(x).index_copy(s, dst, x.index_select(s, src))
