"""Pipeline parallelism: GPipe, 1F1B and interleaved schedules, in driver mode.

The port of the reference's `parallel/pipeline.py` (parity surface: torch
`distributed/pipelining`). There the ``pp`` mesh axis holds one stage per
device inside `shard_map`, and a tick loop runs every stage on its own
device, shifting activations one hop along the ring with `lax.ppermute`.
Here the S stages of a driver-mode ("pp", S) mesh (`mesh.py`: the mesh's
one device in every slot) are the leading dim of one tensor on that
device:

* **Layout.** Stage params are stacked on dim 0 (`stack_stage_params`), so
  a tick is one `torch.func.vmap(stage_fn)` over the S stages. Every stage
  computes every tick, as in the reference's SPMD loop: a stage with no
  microbatch in flight (the bubble) computes on a dummy input whose result
  is masked. A kernel inside `stage_fn` launches once a tick for all S
  stages (the flash Function folds the vmapped dim into B·H).
* **The shift.** `ppermute` i -> i+1 is `torch.roll(y, 1, 0)`, as the ring
  of `context_parallel.py` shifts; the backward shift rolls the other way.
* **GPipe** (`pipeline_apply`): autograd runs through the tick loop, so
  every microbatch's activations live until the backward: O(M) memory.
* **1F1B** (`pipeline_train_1f1b`): forward of microbatch m at stage i at
  tick m + i, its backward at tick m + 2(S-1) - i. Stage inputs wait in a
  ring of depth 2S-1, and the backward recomputes the stage under
  `torch.func.vjp`; no autograd graph outlives its tick, so activation
  memory is O(S), flat in M. The loss head (`loss_fn`) runs on the last
  stage's row only: the other stages' seeds are masked in the reference.
* **Interleaved** (`virtual_stages=V`): global stage s of V·S sits on
  device s mod S as its chunk s // S; a tick runs all V·S chunks in one
  vmap and activations wrap around the ring V times.

Every tick index is known on the host, so the masks of the reference's
`jnp.where` are Python conditions on the tick and the stage: the live
stages of a tick are a contiguous range, and 1F1B adds only their
gradients, by slice.

`axis_name` names the mesh's pipeline axis, as in the reference; the
stage count is the stacked dim's. `jit=` is accepted and ignored, as
`donate=` elsewhere in the port: the schedules run eagerly.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch.func import vjp, vmap
from torch.utils import _pytree as pytree


def _stages(stage_params) -> int:
    return pytree.tree_leaves(stage_params)[0].shape[0]


def _check_stages(stage_params, S: int, what: str) -> None:
    if _stages(stage_params) != S:
        raise ValueError(f"{what}: stage params stack {_stages(stage_params)} stages, the "
                         f"mesh's pp axis holds {S}")


def pipeline_apply(stage_fn: Callable, stage_params, x, axis_name: str = "pp"):
    """GPipe forward over the S stages stacked in `stage_params`.

    stage_fn(params_for_stage, activation) -> activation (same shape).
    stage_params: the stage pytree with the stages on dim 0 (S, ...).
    x: (M, mb, ...) microbatches, read by stage 0. Returns (M, mb, ...),
    the last stage's outputs. Differentiable: autograd runs through the
    M + S - 1 ticks."""
    S, M = _stages(stage_params), x.shape[0]
    run = vmap(stage_fn)
    state = x.new_zeros((S,) + tuple(x.shape[1:]))
    out = []
    for t in range(M + S - 1):
        # stage 0 ingests microbatch t (a dummy past the end); the others
        # take the activation shifted in from the stage before
        inp = torch.cat([x[min(t, M - 1)].unsqueeze(0), state[1:]])
        y = run(stage_params, inp)
        if t >= S - 1:  # the last stage banks microbatch t - (S - 1)
            out.append(y[S - 1])
        state = torch.roll(y, 1, 0)
    return torch.stack(out)


def pipeline_apply_interleaved(stage_fn: Callable, chunk_params, x, axis_name: str = "pp"):
    """Interleaved (looped) forward: `chunk_params` stacks (V, S, ...),
    [v, i] global stage v·S + i on device i (torch's
    `ScheduleInterleaved1F1B` placement). Each tick runs all V·S chunks in
    one vmap; device 0's chunk v takes device S-1's chunk v-1 output (the
    ring's wrap), or x at v = 0. Returns (M, mb, ...); differentiable."""
    V, S = pytree.tree_leaves(chunk_params)[0].shape[:2]
    M = x.shape[0]
    flat = pytree.tree_map(lambda l: l.flatten(0, 1), chunk_params)
    run = vmap(stage_fn)
    state = x.new_zeros((V, S) + tuple(x.shape[1:]))  # the shifted-in activations
    out = []
    for t in range(M + V * S - 1):
        fresh = x[min(t, M - 1)]
        wrapped = torch.cat([fresh.unsqueeze(0), state[:-1, 0]])  # device 0's V inputs
        inp = torch.cat([wrapped.unsqueeze(1), state[:, 1:]], dim=1)
        y = run(flat, inp.flatten(0, 1)).unflatten(0, (V, S))
        if t >= V * S - 1:
            out.append(y[V - 1, S - 1])
        state = torch.roll(y, 1, 1)
    return torch.stack(out)


def pipeline_train_1f1b(stage_fn: Callable, loss_fn: Callable, stage_params, x, targets,
                        axis_name: str = "pp"):
    """1F1B train schedule: returns (mean loss, stacked param grads).

    stage_fn(params, activation) -> activation (same shape across stages);
    loss_fn(final_activation, target_microbatch) -> scalar (a microbatch's
    mean). Loss and grads are averaged over the M microbatches, so they
    match `loss_fn` over the full batch. Tick t on stage i:
      forward microbatch  m_f = t - i
      backward microbatch m_b = t - 2(S-1) + i (the last stage seeds from
                                its own same-tick loss gradient)
    Stage inputs wait in a ring of depth 2S-1 (the most microbatches in
    flight at stage 0); the backward recomputes the stage under
    `torch.func.vjp`, whose graph is dropped within the tick. Its pullback
    runs without grad mode: with it, autograd would pick the
    twice-differentiable composite of some backward formulas (silu's, in
    bf16 without the fused kernel's float32 arithmetic), and the
    gradients would stand ~1% from autograd's at bf16."""
    S, M = _stages(stage_params), x.shape[0]
    D = 2 * S - 1
    x = x.detach()
    run = vmap(stage_fn)
    mb = tuple(x.shape[1:])
    stages = torch.arange(S, device=x.device)
    params = pytree.tree_map(lambda p: p.detach(), stage_params)
    fwd_state = x.new_zeros((S,) + mb)
    bwd_state = x.new_zeros((S,) + mb)
    resid = x.new_zeros((D, S) + mb)
    grads = pytree.tree_map(torch.zeros_like, params)
    loss_sum = torch.zeros((), dtype=torch.float32, device=x.device)
    for t in range(M + 2 * S - 2):
        # ---- forward half: microbatch t - i through stage i -------------
        m_f = [t - i for i in range(S)]
        inp = torch.cat([x[min(t, M - 1)].unsqueeze(0), fwd_state[1:]])
        fwd_live = [i for i in range(S) if 0 <= m_f[i] < M]
        if fwd_live:  # bank each live stage input for its recomputed backward
            live = torch.tensor(fwd_live, device=x.device)
            slots = torch.tensor([m_f[i] % D for i in fwd_live], device=x.device)
            resid[slots, live] = inp[live]
        with torch.no_grad():
            y = run(params, inp)
        # the last stage's loss and seed cotangent (same tick: m_b == m_f)
        m_last = t - (S - 1)
        g_seed = torch.zeros_like(y[S - 1])
        if 0 <= m_last < M:
            tgt = targets[m_last]
            loss_m, loss_vjp = vjp(lambda a: loss_fn(a, tgt), y[S - 1])
            with torch.no_grad():
                (g_seed,) = loss_vjp(torch.ones_like(loss_m))
            loss_sum = loss_sum + loss_m.detach().float()
            del loss_vjp
        # ---- backward half: microbatch t - 2(S-1) + i through stage i ---
        m_b = [t - 2 * (S - 1) + i for i in range(S)]
        lo, hi = max(0, 2 * (S - 1) - t), min(S, M + 2 * (S - 1) - t)  # live: [lo, hi)
        slots = torch.tensor([min(max(m, 0), M - 1) % D for m in m_b], device=x.device)
        saved_in = resid[slots, stages]
        cot = torch.cat([bwd_state[:-1], g_seed.unsqueeze(0)]).to(y.dtype)
        _, stage_vjp = vjp(run, params, saved_in)
        with torch.no_grad():  # first-order backward kernels (see the docstring)
            p_bar, x_bar = stage_vjp(cot)
        del stage_vjp
        for acc, g in zip(pytree.tree_leaves(grads), pytree.tree_leaves(p_bar)):
            acc[lo:hi] += g[lo:hi]  # only the live stages' (an empty slice in the bubble)
        # ---- shift: activations forward, cotangents backward ------------
        fwd_state = torch.roll(y, 1, 0)
        bwd_state = torch.roll(x_bar, -1, 0)  # row i: stage i+1's, zero where that is dead
        bwd_state[:max(lo - 1, 0)] = 0
        bwd_state[hi - 1:] = 0
    return loss_sum / M, pytree.tree_map(lambda g: g / M, grads)


def make_pipeline_train_fn(stage_fn: Callable, loss_fn: Callable, mesh, axis_name: str = "pp",
                           schedule: str = "1f1b", jit: bool = True):
    """(stacked_params, x_mb, y_mb) -> (loss, grads) under `schedule`:
    "1f1b" (`pipeline_train_1f1b`, O(S) activation memory) or "gpipe"
    (autograd through `pipeline_apply`, O(M)). Grads come back stacked on
    the stage dim, the params' layout. `jit` is accepted and ignored."""
    if schedule not in ("1f1b", "gpipe"):
        raise ValueError(f"unknown pipeline schedule {schedule!r}")
    S = mesh.axis_size(axis_name)

    if schedule == "gpipe":
        def train(stacked_params, x, targets):
            _check_stages(stacked_params, S, "make_pipeline_train_fn")
            leaves, spec = pytree.tree_flatten(stacked_params)
            leaves = [l.detach().requires_grad_() for l in leaves]
            out = pipeline_apply(stage_fn, pytree.tree_unflatten(leaves, spec), x, axis_name)
            loss = torch.stack([loss_fn(out[m], targets[m]) for m in range(x.shape[0])]).mean()
            grads = torch.autograd.grad(loss, leaves)
            return loss.detach(), pytree.tree_unflatten(list(grads), spec)

        return train

    def train(stacked_params, x, targets):
        _check_stages(stacked_params, S, "make_pipeline_train_fn")
        return pipeline_train_1f1b(stage_fn, loss_fn, stacked_params, x, targets, axis_name)

    return train


def stack_stage_params(per_stage_params):
    """Stack S per-stage pytrees on a new leading dim (the pp layout)."""
    return pytree.tree_map(lambda *leaves: torch.stack(leaves, 0), *per_stage_params)


def make_pipeline_fn(stage_fn: Callable, mesh, axis_name: str = "pp", jit: bool = True,
                     virtual_stages: int = 1):
    """fn(stacked_params, x) -> (M, mb, ...): `pipeline_apply` over the
    mesh's ``pp`` axis of S stages, or with ``virtual_stages=V`` the
    interleaved schedule over V·S stages stacked in stage order (reshaped
    (V, S, ...): device i holds global stages {v·S + i}). x is (M, mb,
    ...). `jit` is accepted and ignored."""
    S = mesh.axis_size(axis_name)
    V = virtual_stages

    def pipe(stacked_params, x):
        _check_stages(stacked_params, V * S, "make_pipeline_fn")
        if V == 1:
            return pipeline_apply(stage_fn, stacked_params, x, axis_name)
        chunks = pytree.tree_map(lambda l: l.unflatten(0, (V, S)), stacked_params)
        return pipeline_apply_interleaved(stage_fn, chunks, x, axis_name)

    return pipe


def split_microbatches(x, num_microbatches: int):
    """(B, ...) -> (M, B/M, ...) microbatch view."""
    B = x.shape[0]
    if B % num_microbatches != 0:
        raise ValueError(f"batch {B} not divisible by microbatches {num_microbatches}")
    return x.reshape((num_microbatches, B // num_microbatches) + tuple(x.shape[1:]))


def merge_microbatches(y):
    """(M, mb, ...) -> (B, ...)."""
    return y.reshape((y.shape[0] * y.shape[1],) + tuple(y.shape[2:]))

