"""Activation checkpointing that `torch.func` can transform: the port of
the reference's `utils/remat.py` (torch's `checkpoint_wrapper` shape).

The reference wraps a function in `jax.checkpoint`: the forward keeps no
intermediates and the backward reruns it. `torch.utils.checkpoint` cannot
sit inside the DDP step's `vmap(grad(...))` (its saved-tensor hooks and its
reentrant Function are not transformable), so the wrapper here is an
`autograd.Function` in the functorch style: its forward runs the function
without recording, `setup_context` saves only the inputs, and its backward
reruns the function under `torch.func.vjp` and pulls the cotangents back.
`generate_vmap_rule` lets `vmap` batch both halves.

Random inputs stay inputs: the DDP step draws dropout masks outside the
wrapped function and passes them in, so the rerun sees the same masks.
Only the reference's "nothing" policy (save nothing, rerun everything,
torch's `checkpoint_wrapper` semantics) is ported; the reference's other
names map to XLA save policies that have no eager counterpart.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch.func import vjp
from torch.utils import _pytree as pytree

_POLICIES = ("nothing",)


def _differentiable(t) -> bool:
    return isinstance(t, torch.Tensor) and (t.is_floating_point() or t.is_complex())


class _Checkpoint(torch.autograd.Function):
    generate_vmap_rule = True

    @staticmethod
    def forward(run, *flat):
        with torch.no_grad():
            return run(*flat)

    @staticmethod
    def setup_context(ctx, inputs, output):
        run, *flat = inputs
        ctx.run = run
        ctx.tensor_at = [i for i, a in enumerate(flat) if isinstance(a, torch.Tensor)]
        ctx.others = [None if isinstance(a, torch.Tensor) else a for a in flat]
        ctx.save_for_backward(*[flat[i] for i in ctx.tensor_at])
        ctx.float_out = [i for i, o in enumerate(output) if _differentiable(o)]
        ctx.mark_non_differentiable(*[o for o in output if not _differentiable(o)])

    @staticmethod
    def backward(ctx, *cts):
        flat = list(ctx.others)
        for i, t in zip(ctx.tensor_at, ctx.saved_tensors):
            flat[i] = t
        diff = [i for i, a in enumerate(flat) if _differentiable(a)]

        def rerun(*xs):
            args = list(flat)
            for i, x in zip(diff, xs):
                args[i] = x
            out = ctx.run(*args)
            return tuple(out[i] for i in ctx.float_out)

        with torch.enable_grad():
            _, pull = vjp(rerun, *[flat[i] for i in diff])
        grads = pull(tuple(cts[i] for i in ctx.float_out))
        out = [None] * len(flat)
        for i, gr in zip(diff, grads):
            out[i] = gr
        return (None, *out)


def checkpoint_wrapper(fn: Callable, policy: str = "nothing") -> Callable:
    """`fn` rematerialized: the same values, nothing kept from its forward.

    `fn` takes and returns pytrees (dicts, tuples, None) of tensors and
    other values; its outputs must be tensors or None. The wrapper works
    under `torch.func.vmap` and `grad` and under plain autograd."""
    if policy not in _POLICIES:
        raise ValueError(f"unknown checkpoint policy {policy!r}; the port has {_POLICIES}")
    out_spec = []

    def wrapped(*args):
        flat, in_spec = pytree.tree_flatten(args)

        def run(*xs):
            out = fn(*pytree.tree_unflatten(list(xs), in_spec))
            leaves, spec = pytree.tree_flatten(out)
            if not out_spec:
                out_spec.append(spec)
            return tuple(leaves)

        leaves = _Checkpoint.apply(run, *flat)
        return pytree.tree_unflatten(list(leaves), out_spec[0])

    return wrapped


def apply_activation_checkpointing(apply_fn: Callable, check_fn: Optional[Callable] = None,
                                   policy: str = "nothing", **static_kwargs) -> Callable:
    """torch's `apply_activation_checkpointing(model, check_fn=...)` shape:
    `apply_fn` (keyword arguments in `static_kwargs` bound first) with its
    whole forward rematerialized. `check_fn` (per-submodule selection) must
    be None, as in the reference."""
    if check_fn is not None:
        raise NotImplementedError(
            "per-submodule selection: wrap the submodule's function with "
            "checkpoint_wrapper instead")
    base = (lambda *args: apply_fn(*args, **static_kwargs)) if static_kwargs else apply_fn
    return checkpoint_wrapper(base, policy=policy)
