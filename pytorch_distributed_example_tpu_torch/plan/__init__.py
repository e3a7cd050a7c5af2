"""Topology-aware collective planner (PCCL arxiv 2606.07019, "The Big
Send-off" arxiv 2504.18658).

The port of the reference's `plan/` package. Instead of one fixed lowering
per collective, the planner synthesizes ring / recursive-halving-doubling
/ hierarchical schedules per `(op, payload-size bucket, group, topology)`
and picks among them from MEASURED probes persisted in an on-disk cache
keyed by topology. Two execution planes realize a chosen plan:

* **driver** — the schedule runs as a rank-stacked body over the group's
  W rows (`driver.py`); `ProcessGroup._dispatch` swaps it in for the
  stock fold, and the DDP step inherits it leaf by leaf through
  `ddp_comm_hook`;
* **multiproc p2p** — the schedule executes literally over the direct
  TCP data plane (`executor.py` walking `p2p.py` send/recv/recv_any),
  with every round fingerprinted through the schedule verifier and a
  `plan.step` fault seam, so a mid-collective fault surfaces as a named
  `ScheduleMismatchError` rather than a hang.

`traced.py` is the seam of the step bodies (TP's sums and gathers, ZeRO's
halves, the DDP hook): probe and agree on the host, then pure table
lookups where the step runs.

Opt-in: `TDX_COLLECTIVE_PLANNER=1` globally, or per group via
`enable_for_group(pg, True/False)` (the override wins over the env in
both directions). The stock lowering stays a first-class probe
candidate ("onepass"): where it measures fastest, the planner dispatches
it unchanged. `schedules.py`, `topology.py` and `transfer.py` are copies
of the reference's.
"""

from __future__ import annotations

import math
import os
from typing import Optional

from . import driver, executor, probe, schedules, topology, traced, transfer
from .planner import CollectivePlanner
from .schedules import Plan, Round, Step
from .topology import Topology
from .transfer import chunk_spans, schedule_migration

__all__ = [
    "CollectivePlanner", "Plan", "Round", "Step", "Topology",
    "active_for_group", "enable_for_group", "planner_for_group",
    "maybe_lower", "ddp_comm_hook", "reset_group",
    "schedule_migration", "chunk_spans",
    "driver", "executor", "probe", "schedules", "topology", "traced",
    "transfer",
]

_ENV = "TDX_COLLECTIVE_PLANNER"
_PLANNABLE = ("all_reduce", "all_gather", "reduce_scatter")


def active_for_group(group) -> bool:
    ov = getattr(group, "planner_override", None)
    if ov is not None:
        return bool(ov)
    return os.environ.get(_ENV, "0") == "1"


def enable_for_group(group, enabled: Optional[bool]) -> None:
    """Per-group override: True/False pins the planner on/off for this
    group regardless of TDX_COLLECTIVE_PLANNER; None defers to the env."""
    group.planner_override = enabled
    if not enabled:
        reset_group(group)


def reset_group(group) -> None:
    """Drop the group's cached planner (tests / topology changes)."""
    group._collective_planner = None


def planner_for_group(group) -> CollectivePlanner:
    pl = getattr(group, "_collective_planner", None)
    if pl is None:
        topo = topology.detect(group)
        pl = CollectivePlanner(topo, mesh=group.mesh, axis=driver.AXIS)
        group._collective_planner = pl
    return pl


def _backend_supported(group) -> bool:
    from ..backends.process import ProcessBackend
    from ..backends.stacked import StackedBackend

    return isinstance(group.backend_impl, (StackedBackend, ProcessBackend))


_OPTYPE = {"all_reduce": "ALLREDUCE", "all_gather": "ALLGATHER",
           "reduce_scatter": "REDUCE_SCATTER"}


def maybe_lower(group, op_name: str, tensor, plan_args: dict, fallback=None):
    """The `_dispatch` seam: return a zero-arg callable producing
    `(out, work)` that runs the planner's chosen schedule, or None to
    take the stock lowering (planner off, op unplannable, reduce op
    outside the synthesized algebra, "onepass" won the probe, the
    transport is unavailable, or a `traced` seam is dispatching and has
    already chosen). ``fallback`` is the stock lowering callable; the
    plane path keeps it for conditions only discoverable under watchdog
    coverage (an opted-out peer endpoint)."""
    if tensor is None or op_name not in _PLANNABLE or traced.dispatching():
        return None
    if not active_for_group(group) or group.size() < 2:
        return None
    if not _backend_supported(group):
        return None
    try:
        reduce_kind = (
            driver.reduce_kind_of(plan_args["reduce_op"])
            if "reduce_op" in plan_args
            else "sum"
        )
    except KeyError:
        return None  # PRODUCT / bitwise / PREMUL: stock lowering only
    from .. import distributed as dist

    if dist._world.mode == "multiproc":
        return _lower_plane(group, op_name, tensor, reduce_kind, fallback)
    return _lower_driver(group, op_name, tensor, reduce_kind)


# -- driver plane -----------------------------------------------------------


def _lower_driver(group, op_name: str, tensor, reduce_kind: str):
    from ..types import OpType, TensorWork

    pl = planner_for_group(group)
    W = group.size()
    per_rank_bytes = max(tensor.numel() * tensor.element_size() // W, 1)
    alg, _source = pl.choose(op_name, per_rank_bytes, reduce_kind, "driver")
    if alg == "onepass":
        return None  # the probe chose the stock lowering: dispatch it
    # per-rank element count the plan covers (all_gather: block;
    # reduce_scatter: per-chunk; all_reduce: flat payload)
    shape = tuple(tensor.shape)
    nelems = math.prod(shape[2:] if op_name == "reduce_scatter" else shape[1:])
    plan = pl.plan_for(op_name, alg, nelems)
    sched = getattr(group, "_sched", None)
    cache = pl.__dict__.setdefault("_driver_progs", {})
    key = (op_name, alg, W, reduce_kind)
    prog = cache.get(key)
    if prog is None:
        prog = driver.compiled_body(op_name, alg, W, driver.AXIS, pl.mesh, reduce_kind)
        cache[key] = prog
    optype = getattr(OpType, _OPTYPE[op_name])

    def fn():
        if sched is not None:
            # the plan's per-round step sequence enters the schedule
            # fingerprint exactly as on the p2p plane (driver mode:
            # world-1 structural agreement, fingerprint path only)
            for i, rnd in enumerate(plan.rounds):
                sched.record(
                    i, f"plan.{op_name}.{alg}", (plan.nelems,),
                    str(tensor.dtype), detail=rnd.descriptor(),
                )
        out = prog(tensor)
        return out, TensorWork(out, optype, f"plan:{alg}", device=out.device)

    return fn


def ddp_comm_hook(group):
    """Planner-aware default gradient hook for the DDP step, or None when
    the planner is off for this group. Applied leaf by leaf: each
    gradient leaf takes the agreed schedule for its own size bucket
    (`plan/traced.py`), so one step can mix the one-shot mean for biases
    with a ring schedule for the big matmul gradients. The step prepares
    the table on the host before its first call (`prepare_for_params`);
    in multiproc mode that table was store-agreed, so every rank runs
    the same schedule. Driver mode also falls back to the group
    planner's cache for unprepared buckets (`group=` below)."""
    if not active_for_group(group) or group.size() < 2:
        return None
    if not _backend_supported(group):
        return None
    from .. import distributed as dist
    from ..parallel import comm_hooks

    return comm_hooks.planner_hook(
        group=group if dist._world.mode != "multiproc" else None
    )


# -- multiproc p2p plane ----------------------------------------------------


def _agreed_plane_choice(group, me: int, op_name: str, per_rank_bytes: int,
                         reduce_kind: str, pl):
    """Gang-agreed (algorithm, pipeline_chunks) for a plane collective.
    Each process may hold a DIFFERENT probe cache (per-host disks) — and
    a different TDX_PLAN_PIPELINE_CHUNKS env — so a purely local
    `choose()` could hand two ranks two different schedules or chunk
    splits. Group rank 0's choice (chunk count included: frame sizes and
    per-peer sequence numbers depend on it) is published through the
    (incarnation-scoped) group store once per (op, bucket); everyone
    else adopts it."""
    bucket = probe.bucket_bytes(per_rank_bytes)
    agreed = pl.__dict__.setdefault("_agreed_plane", {})
    hit = agreed.get((op_name, bucket))
    if hit is not None:
        return hit
    alg, _source = pl.choose(op_name, per_rank_bytes, reduce_kind, "plane")
    pipe = (
        executor.default_pipeline_chunks()
        if alg in schedules.EXEC_VARIANTS
        else 1
    )
    if group.store is not None and group.size() > 1:
        from .. import distributed as dist

        key = f"planalg/gen{dist._world.scope}/{op_name}/{bucket}"
        if me == 0:
            group.store.set(key, f"{alg}:{pipe}".encode())  # storelint: disable=S005 -- probe-agreement rows keyed gen/op/bucket, pinned for replay within the job; reclaimed with its store
        else:
            group.store.wait([key], group.timeout)
            raw = group.store.get(key).decode()
            alg, _, p = raw.partition(":")
            pipe = int(p) if p else 1
    agreed[(op_name, bucket)] = (alg, pipe)
    return alg, pipe


def _lower_plane(group, op_name: str, tensor, reduce_kind: str, fallback=None):
    """Lower onto the direct p2p data plane: this process's row goes to
    the host (a CUDA row through pinned memory, by the plane) and the plan
    is walked there; the result comes back on the row's device.

    Only non-blocking checks run here, at dispatch-decision time: every
    STORE-BLOCKING step — endpoint resolution, topology inference, the
    rank-0 choice agreement — happens inside the returned callable,
    which `_dispatch` runs under watchdog coverage. An opted-out peer
    endpoint (rank-agreed: every rank reads the same store value) falls
    back to the stock lowering via ``fallback``."""
    from .. import distributed as dist
    from ..types import CompletedWork, OpType

    plane = dist._p2p_plane
    if plane is None or not plane.listening:
        return None
    me = group.rank()
    if me < 0:
        return None  # non-member constructed the group collectively
    W = group.size()
    optype = getattr(OpType, _OPTYPE[op_name])

    def fn():
        for r in range(W):
            if r == me:
                continue
            ep = plane.endpoint_of(group.get_global_rank(r), group.timeout)
            if ep is None:
                if fallback is not None:
                    return fallback()  # rank-agreed: peer opted out
                raise RuntimeError(
                    f"planner: rank {r} has no p2p listener and no stock "
                    "fallback was provided"
                )
        pl = planner_for_group(group)
        local = tensor[0]
        alg, pipeline = _agreed_plane_choice(
            group, me, op_name, max(local.numel() * local.element_size(), 1),
            reduce_kind, pl)
        if op_name == "reduce_scatter":
            nelems = int(local[0].numel()) if local.dim() >= 1 else 1
        else:
            nelems = int(local.numel())
        plan = pl.plan_for(op_name, alg, nelems)
        # execution variants: same plan, pipelined executor walk; the
        # chunk count is rank-agreed above and rides the verified
        # |pipeN round descriptors
        ctr = getattr(group, "_plan_route_ctr", 0)
        group._plan_route_ctr = ctr + 1
        route = f"plan/{dist._world.scope}/{group.group_name}/{ctr}"
        res = executor.execute(
            plan, me, local, plane,
            route=route,
            reduce_kind="sum" if reduce_kind == "avg" else reduce_kind,
            average=reduce_kind == "avg",
            timeout=group.timeout,
            verifier=getattr(group, "_sched", None),
            to_global=group.get_global_rank,
            pipeline_chunks=pipeline,
        )
        if op_name == "all_reduce":
            shape = tuple(local.shape)
        elif op_name == "all_gather":
            # plan blocks are the flat per-rank payload; restore (W, *s)
            shape = (W,) + tuple(local.shape)
        else:  # reduce_scatter: own chunk, shaped like one list entry
            shape = tuple(local.shape[1:])
        dtype = local.dtype if reduce_kind != "avg" or local.is_floating_point() else res.dtype
        out = res.reshape(shape).to(device=tensor.device, dtype=dtype)[None]
        return out, CompletedWork(out, optype)

    return fn
