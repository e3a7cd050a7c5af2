"""Tensor parallelism: Megatron column/row sharding, in both modes.

The port of the reference's `parallel/tensor_parallel.py`. A TP style is a
layout of a layer's weight over the ``tp`` mesh axis: column-parallel
shards its output features, row-parallel its input features.
`parallelize_module` lays a module's parameters out so (as `DTensor`s).

The explicit seams (Megatron's f/g operators) run on rank-stacked tensors:
a dim of the tp ranks leads every sharded operand (`w_local` is
(tp, in, out_local) for a column-parallel weight, in the reference's
(in, out) layout), and a replicated activation is held once (the replica
form of `nn.functional`). A column-parallel matmul gives every tp rank the
replica (`nn.functional.replicate`: backward all_reduce), a row-parallel
one all-reduces the ranks' partial products (`all_reduce(replica=True)`:
backward copy). The reference routes its reductions through the traced
planner seam (`plan/traced.py`); the port's use `nn.functional` until
the planner is ported (ROADMAP). Inside an entered multiproc mesh each
process is one tp rank: the leading tp dim has size 1, and the seams'
reductions are collectives of the tp group (`nn.functional`'s multiproc
mode); the row-parallel partials stay float32 through the all-reduce.

`shard_kv_pool`, `kv_pool_spec` and `replicate_tree` place the serve
engine's paged KV pool and slot lanes over a driver-mode ``tp`` mesh.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Sequence

import torch
import torch.nn.functional as F

from .. import mesh as _mesh
from ..dtensor import Replicate, distribute_tensor, spec_to_placements
from ..mesh import DeviceMesh
from ..nn import functional as nnf
from ..types import ReduceOp
from . import sharding as shd


@dataclass
class ColwiseParallel:
    """Shard a linear layer's output features over ``tp`` (Megatron column):
    `Linear.weight` (out, in) -> (tp, None), bias (out,) -> (tp,);
    `Embedding.weight` (V, D) -> (None, tp)."""

    axis: str = "tp"


@dataclass
class RowwiseParallel:
    """Shard a linear layer's input features over ``tp`` (Megatron row):
    `Linear.weight` -> (None, tp), bias replicated (added after the
    all-reduce); `Embedding.weight` -> (tp, None)."""

    axis: str = "tp"


@dataclass
class SequenceParallel:
    """Replicate weights; activations sharded on sequence (with norms)."""

    axis: str = "sp"


ParallelStyle = Any


def tp_rules_for_plan(plan: Dict[str, ParallelStyle]) -> Sequence[shd.Rule]:
    """A torch-`parallelize_module`-shaped plan (module-name regex -> style)
    as rule entries for `Linear`-shaped (out, in) weights.
    `parallelize_module` lays embeddings out by their own table."""
    rules = []
    for pat, style in plan.items():
        if isinstance(style, ColwiseParallel):
            rules.append((pat + r".*\.weight", (style.axis, None)))
            rules.append((pat + r".*\.bias", (style.axis,)))
        elif isinstance(style, RowwiseParallel):
            rules.append((pat + r".*\.weight", (None, style.axis)))
            rules.append((pat + r".*\.bias", (None,)))
        elif isinstance(style, SequenceParallel):
            rules.append((pat + r".*", (None,)))
        else:
            raise TypeError(f"unknown parallel style {style!r}")
    return rules


def _embedding_rules(module: torch.nn.Module, plan) -> Sequence[shd.Rule]:
    rules = []
    for name, m in module.named_modules():
        if not isinstance(m, torch.nn.Embedding):
            continue
        for pat, style in plan.items():
            if re.search(pat, name):
                axes = ((None, style.axis) if isinstance(style, ColwiseParallel)
                        else (style.axis, None) if isinstance(style, RowwiseParallel)
                        else (None,))
                rules.append((re.escape(name + ".weight") + "$", axes))
                break
    return rules


def parallelize_module(module, mesh: DeviceMesh, plan: Dict[str, ParallelStyle]):
    """Lay ``module``'s parameters out per the TP plan (torch
    `parallelize_module`); everything the plan does not name replicates.
    Takes a module (embeddings are recognised by type) or a mapping of
    name -> tensor. Returns (name -> DTensor, name -> spec)."""
    rules = list(_embedding_rules(module, plan)) if isinstance(module, torch.nn.Module) else []
    rules += list(tp_rules_for_plan(plan))
    rules.append((r".*", ()))
    return shd.shard_params(module, mesh, rules)


def _bmm_f32(a, b):
    """a @ b over the leading dims, float32 out: bf16 operands keep their
    tensor-core product and its float32 accumulator (`out_dtype`; the CPU
    has no such kernel and multiplies in float32)."""
    lead = a.shape[:-2]
    a3, b3 = a.reshape(-1, *a.shape[-2:]), b.reshape(-1, *b.shape[-2:])
    if a.dtype == torch.float32:
        out = torch.bmm(a3, b3.float())
    elif a.is_cuda:
        out = torch.bmm(a3, b3, out_dtype=torch.float32)
    else:
        out = torch.bmm(a3.float(), b3.float())
    return out.reshape(*lead, *out.shape[-2:])


class _ColumnParallel(torch.autograd.Function):
    """y_t = x @ w_t for every tp rank t of the replica x (Megatron's f:
    the backward all-reduces the ranks' dx partials, kept in float32 so
    the sum rounds once, as one matmul over every column would)."""

    @staticmethod
    def forward(ctx, x, w, axis):
        ctx.save_for_backward(x, w)
        ctx.axis, ctx.scope = axis, _mesh.scope()
        return torch.matmul(x.unsqueeze(0), w)

    @staticmethod
    def backward(ctx, ct):
        x, w = ctx.saved_tensors
        partial = _bmm_f32(ct, w.transpose(-1, -2))
        with _mesh.restored(ctx.scope):  # the forward's tp group
            dx = nnf.all_reduce(partial, ReduceOp.SUM, ctx.axis, replica=True).to(x.dtype)
        dw = torch.matmul(x.unsqueeze(0).transpose(-1, -2), ct)
        return dx, dw, None


class _RowParallel(torch.autograd.Function):
    """y = sum_t x_t @ w_t into one replica (Megatron's g): the partial
    products in float32, all-reduced, rounded once to x's dtype, as the
    reference's `preferred_element_type=float32` product and psum. The
    backward hands each rank the cotangent (copy)."""

    @staticmethod
    def forward(ctx, x, w, axis):
        ctx.save_for_backward(x, w)
        partial = _bmm_f32(x, w)
        return nnf.all_reduce(partial, ReduceOp.SUM, axis, replica=True).to(x.dtype)

    @staticmethod
    def backward(ctx, ct):
        x, w = ctx.saved_tensors
        ct = ct.unsqueeze(0)
        return (torch.matmul(ct, w.transpose(-1, -2)), torch.matmul(x.transpose(-1, -2), ct),
                None)


def column_parallel(x, w_local, axis: str = "tp"):
    """The replica x (*batch, N, in) against the tp ranks' output-feature
    shards w_local (tp, *batch, in, out_local): (tp, *batch, N, out_local)
    in x's dtype (f)."""
    return _ColumnParallel.apply(x, w_local.to(x.dtype), axis)


def row_parallel(x_local, w_local, axis: str = "tp"):
    """The tp ranks' input-feature shards x_local (tp, *batch, N, in_local)
    against w_local (tp, *batch, in_local, out), summed over the ranks
    into one replica (*batch, N, out) in x's dtype (g)."""
    return _RowParallel.apply(x_local, w_local.to(x_local.dtype), axis)


def column_parallel_matmul(x, w_local, axis: str = "tp"):
    """The reference's seam: the replica x (..., in) against the ranks'
    column blocks (tp, in, out_local) -> (tp, ..., out_local)."""
    T, lead = w_local.shape[0], x.shape[:-1]
    y = column_parallel(x.reshape(-1, x.shape[-1]), w_local, axis)
    return y.reshape(T, *lead, y.shape[-1])


def row_parallel_matmul(x_local, w_local, axis: str = "tp"):
    """The reference's seam: the ranks' row blocks x_local (tp, ..., in_local)
    against (tp, in_local, out) -> the replica (..., out)."""
    T, lead = x_local.shape[0], x_local.shape[1:-1]
    y = row_parallel(x_local.reshape(T, -1, x_local.shape[-1]), w_local, axis)
    return y.reshape(*lead, y.shape[-1])


def _gelu(x):
    return F.gelu(x, approximate="tanh")  # jax.nn.gelu's default


def mlp_block_tp(x, w_up_local, w_down_local, axis: str = "tp", act: Optional[Callable] = None):
    """A full Megatron MLP block: column-parallel up, act, row-parallel
    down, one all-reduce."""
    act = act or _gelu
    h = column_parallel_matmul(x, w_up_local, axis)
    return row_parallel_matmul(act(h), w_down_local, axis)


def vocab_parallel_logits(h, emb_local, axis: str = "tp"):
    """Vocab-parallel LM head: each rank's logits chunk (float32) of the
    replica h against its (tp, D, V/tp) shard, all-gathered on the last
    dim into one replica (..., V)."""
    T, lead = emb_local.shape[0], h.shape[:-1]
    hs = nnf.replicate(h.reshape(-1, h.shape[-1]), axis, T)
    local = torch.bmm(hs.float(), emb_local.float())  # (T, N, V/T)
    return nnf.all_gather(local, axis, -1, replica=True).reshape(*lead, -1)


def gathered_matmul(x_local, w, axis: str = "tp"):
    """y = all_gather(x_local) @ w: the ranks' row blocks (tp, n, D)
    gathered into one replica (tp*n, D) against a replicated weight."""
    full = nnf.all_gather(x_local, axis, 0, replica=True)
    return (full.float() @ w.float()).to(x_local.dtype)


def vocab_parallel_cross_entropy(local_logits, targets, axis: str = "tp",
                                 ignore_index: int = -100):
    """Cross-entropy against vocab-sharded logits, without the full-vocab
    gather (torch `loss_parallel`, Megatron's vocab-parallel CE).

    `local_logits` is (tp, ..., V/tp), rank t holding vocab ids
    [t*V/tp, (t+1)*V/tp); `targets` (...) are global ids. The global
    logsumexp takes the detached max over every rank and one all-reduced
    sum, the target logit one masked all-reduce. Returns per-element
    losses (targets' shape); positions equal to `ignore_index` give 0 loss
    and 0 gradient."""
    T, V_local = local_logits.shape[0], local_logits.shape[-1]
    if _mesh.axis_binding(axis) is None:
        m = local_logits.detach().amax(-1).amax(0)  # the stability shift, no gradient
    else:
        m = nnf.all_reduce(local_logits.detach().amax(-1), ReduceOp.MAX, axis, replica=True)
    z = nnf.all_reduce(torch.exp(local_logits - m.unsqueeze(-1)).sum(-1), ReduceOp.SUM, axis,
                       replica=True)
    offset = (nnf.rank_ids(axis, T, targets.device) * V_local).reshape(
        (T,) + (1,) * targets.dim())
    local_idx = targets.unsqueeze(0) - offset
    in_shard = (local_idx >= 0) & (local_idx < V_local)
    safe = local_idx.clamp(0, V_local - 1)
    picked = local_logits.gather(-1, safe.unsqueeze(-1)).squeeze(-1)
    target_logit = nnf.all_reduce(torch.where(in_shard, picked, torch.zeros_like(picked)),
                                  ReduceOp.SUM, axis, replica=True)
    loss = torch.log(z) + m - target_logit
    return torch.where(targets == ignore_index, torch.zeros_like(loss), loss)


# torch.distributed.tensor.parallel.loss_parallel-shaped alias
loss_parallel = vocab_parallel_cross_entropy



# ---------------------------------------------------------------------------
# serve-engine decode placement (paged KV pool + replicated slot state)
# ---------------------------------------------------------------------------


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def kv_pool_spec(x, mesh: DeviceMesh, axis: str = "tp"):
    """The pool layout rule for ONE leaf (reference :246-265): 4-d
    (nblk, bs, KV, Dh) K/V pools and 3-d (nblk, bs, KV) scale planes (the
    int8 pool's per-token scales) shard on their KV-head axis (dim 2);
    anything else, and a leaf whose KV-head dim does not divide the axis,
    replicates. The block count includes the port's sink block, which
    every rank's shard carries. Returns a spec (one mesh-axis name or
    None per dim, as `parallel.sharding.spec_for`)."""
    if x.dim() in (3, 4) and x.shape[2] % mesh.axis_size(axis) == 0:
        return (None, None, axis)
    return ()


def shard_kv_pool(tree, mesh: DeviceMesh, axis: str = "tp"):
    """Place a paged KV pool tree (per layer (num_blocks + 1, block_size,
    kv_heads, head_dim) K/V, `serve/cache.py`) onto `mesh` by
    `kv_pool_spec`: each leaf a `DTensor`, KV-head sharded leaves stored
    rank-leading as (T, num_blocks + 1, block_size, kv_heads / T, ...),
    so tp rank t holds heads [t·KV/T, (t+1)·KV/T) of every block, the
    sink included."""
    return _tree_map(lambda x: distribute_tensor(
        x, mesh, spec_to_placements(kv_pool_spec(x, mesh, axis), mesh)), tree)


def replicate_tree(tree, mesh: DeviceMesh):
    """Replicate every leaf of `tree` across `mesh` (the serve engine's
    slot lanes: lengths, tokens and keys are (S,)-shaped, and sharding
    them would cost a gather per readback). In driver mode a replicated
    `DTensor` holds its value once."""
    return _tree_map(lambda x: distribute_tensor(x, mesh, [Replicate()] * len(mesh.shape)),
                     tree)
