"""Trace-time planner dispatch — probe-agreed schedules inside the step
(PCCL arxiv 2606.07019, "Big Send-off" arxiv 2504.18658).

The port of the reference's `plan/traced.py`. The port's "trace" is the
body a `torch.func` transform runs (the rank `vmap` of a step) or that
`torch.compile` traces, and the eager seams the reference compiles: TP's
row-parallel sums and gathers, ZeRO's reduce-scatter and all-gather
halves, the DDP comm hook. The dispatch functions here take the
rank-stacked tensors of `nn/functional.py` (rank dim first: W rows in
driver mode, this process's one row inside an entered multiproc mesh) and
lower a chosen ring/rhd schedule as `plan/driver.py`'s bodies; the
group-level form (`on_group`) serves `ProcessGroup` call sites.

The eager planner (`plan/__init__.maybe_lower`) swaps measured
schedules into `ProcessGroup._dispatch`; choosing INSIDE a trace is
illegal twice over: probing runs host programs under the tracer, and a
choice made from process-local state (per-host probe caches, a skewed
`TDX_PLANNER_FORCE`) runs divergent schedules across a multiproc gang —
a silent hang at first dispatch.

This module makes the choice legal by splitting it in time:

1. **Probe outside the trace** — `prepare()` runs at step-factory /
   first-dispatch time on the host, keyed
   `(op, payload-size bucket, reduce kind)` per process, choosing via
   the group's `CollectivePlanner` (force → cache → probe → structural
   default).  Calling it under tracing raises `TraceGuardError` — the
   probe can never run host ops inside a trace.
2. **Agree before the step runs** — in multiproc mode each chosen
   entry rides a sequence-keyed `schedule.agree_program` round
   (`traced{seq}` keys under a `planagree` store prefix): group rank 0's
   choice is adopted by unforced ranks, then every rank publishes the
   schedule's round descriptors and a skewed gang fails at step-factory
   time with the first divergent eqn named, instead of hanging in the
   first collective.
3. **Dispatch inside the trace** — `all_reduce` / `all_gather` /
   `reduce_scatter` here are pure table lookups (no store op, no probe,
   no host readback) that lower the agreed algorithm as
   `plan/driver.py`'s bodies; no agreed entry means the stock
   collective (with a one-shot warning when the planner is on). While a
   seam dispatches, the eager planner stays out of the collectives it
   issues (`plan.maybe_lower` declines), so the seam's choice is final.

**Overlap** (`TDX_PLANNER_OVERLAP`, default on): a ring all-gather runs as
its W-1 neighbour shifts, and `all_gather_matmul` multiplies each landed
chunk as it arrives.  `=0` pins every gather back to the one-shot
collective (`TDX_PLANNER_FORCE` and `TDX_COLLECTIVE_PLANNER=0` are
honored inside traces the same way).
"""

from __future__ import annotations

import contextlib
import hashlib
import os
import threading
import warnings
from typing import Callable, Dict, Iterable, Optional, Tuple

import torch

from .. import traceguard
from . import driver, probe, schedules

__all__ = [
    "enabled", "overlap_enabled", "reset", "seed", "lookup",
    "prepare", "prepare_for_params",
    "all_reduce", "all_gather", "reduce_scatter", "all_gather_matmul",
    "on_group", "agree_entry", "dispatching",
]

_ENV = "TDX_COLLECTIVE_PLANNER"
_ENV_FORCE = "TDX_PLANNER_FORCE"
_ENV_OVERLAP = "TDX_PLANNER_OVERLAP"
_AGREE_PREFIX = "planagree"

# The process-wide agreed schedule table: (op, bucket, reduce_kind) ->
# {"alg", "world", "source"}.  Filled only by prepare()/seed() on the
# host; read (pure) by the dispatch functions at trace time.  Reset on
# process-group teardown (`distributed.destroy_process_group`).
_TABLE: Dict[Tuple[str, int, str], Dict] = {}
# Global agreement-round counter — the sequence-key discipline:
# rounds are keyed by POSITION (`traced{seq}`), not by name, so a rank
# that prepared a different entry at the same position is diagnosed
# instead of timing out on a key that never appears.  Advanced only on
# success: a timed-out round retries under the SAME key (idempotent
# re-publish), so a rank joining mid-agreement converges cleanly.
_AGREE_SEQ = [0]
_WARNED: set = set()


def enabled(group=None) -> bool:
    """Is the traced planner active?  Per-group override wins when a
    group is supplied (mirrors `plan.active_for_group`)."""
    if group is not None:
        from . import active_for_group

        return active_for_group(group)
    return os.environ.get(_ENV, "0") == "1"


def overlap_enabled() -> bool:
    return os.environ.get(_ENV_OVERLAP, "1") != "0"


def reset() -> None:
    """Drop the agreed table + warning dedup (tests, PG teardown)."""
    _TABLE.clear()
    _WARNED.clear()
    _AGREE_SEQ[0] = 0


def seed(op: str, alg: str, *, world: int, nbytes: int,
         reduce_kind: str = "sum", source: str = "seed") -> None:
    """Insert one agreed entry directly (tests, lint catalogs, benches
    with a pre-probed table)."""
    bucket = probe.bucket_bytes(max(int(nbytes), 1))
    _TABLE[(op, bucket, reduce_kind)] = {
        "alg": alg, "world": int(world), "source": source,
    }


def lookup(op: str, nbytes: int, reduce_kind: str = "sum") -> Optional[Dict]:
    """Pure table lookup by payload size (trace-safe)."""
    bucket = probe.bucket_bytes(max(int(nbytes), 1))
    return _TABLE.get((op, bucket, reduce_kind))


# ---------------------------------------------------------------------------
# host side: probe + agree (OUTSIDE any trace)
# ---------------------------------------------------------------------------


def _choose_no_probe(pl, op: str, nbytes: int, reduce_kind: str):
    """Planner choice with probing suppressed (multiproc prepare: the
    probe would run collectives unilaterally; force/cache still apply,
    else the structural default)."""
    saved = pl._probe_fn
    pl._probe_fn = lambda *a, **k: None
    try:
        return pl.choose(op, nbytes, reduce_kind, "driver")
    finally:
        pl._probe_fn = saved


def _plan_eqns(pl, op: str, alg: str, world: int, bucket: int,
               reduce_kind: str):
    """The ordered round descriptors the agreement round publishes —
    divergent algorithms differ at round 1, so
    `ProgramScheduleMismatchError` names eqn #1 with both ranks'
    schedules spelled out."""
    if alg == "onepass":
        return [f"{op}.onepass|{reduce_kind}|stock-lowering|b{bucket}"]
    base = schedules.EXEC_VARIANTS.get(alg, alg)
    # deterministic per-rank element count derived from the agreed
    # bucket: every rank synthesizes the identical plan
    nelems = max(bucket // 4, world)
    plan = pl.plan_for(op, base, nelems)
    return [
        f"{op}.{alg}|w{world}|{reduce_kind}|round{i}|{rnd.descriptor()}"
        for i, rnd in enumerate(plan.rounds)
    ]


def agree_entry(store, rank: int, world: int, seq: int, *, op: str,
                bucket: int, reduce_kind: str, eqns, timeout=None) -> None:
    """One `schedule.agree_program` round for one table entry: publish this
    rank's schedule descriptors under the position key `traced{seq}`
    and compare every peer's.  Raises `ProgramScheduleMismatchError`
    naming the first divergent eqn on skew; idempotent per (seq,
    payload), so retrying after a peer's late join republishes the
    same row and succeeds."""
    from .. import schedule

    digest = hashlib.sha256(
        "\n".join([op, str(bucket), reduce_kind, str(world)] + list(eqns))
        .encode()
    ).hexdigest()
    schedule.agree_program(
        store, rank, world, f"traced{seq}",
        {
            "name": f"plan.traced.{op}/b{bucket}/{reduce_kind}",
            "digest": digest,
            "eqns": list(eqns),
        },
        timeout=timeout,
    )


def prepare(group, entries: Iterable[Tuple[str, int, str]], *,
            timeout: Optional[float] = None) -> Dict:
    """Choose + agree schedules for ``entries`` (each
    ``(op, per_rank_bytes, reduce_kind)``) and install them in the
    process-wide table.  Host-only: raises `TraceGuardError` under
    tracing (a `torch.func` transform or `torch.compile`) — probing and
    the store agreement are host ops the trace must never reach.
    Multiproc gangs must call this collectively (SPMD discipline) with
    identical entries; a skewed `TDX_PLANNER_FORCE` fails here, before
    the step runs, naming the first divergent eqn."""
    if traceguard.under_tracing():
        raise traceguard.TraceGuardError(
            "plan.traced.prepare called under tracing: the schedule "
            "probe runs host programs and store agreement rounds — host "
            "ops that must complete BEFORE the trace (call prepare() at "
            "step-factory time, then dispatch reads the agreed table "
            "purely)"
        )
    from .. import distributed as dist
    from . import planner_for_group

    W = group.size()
    if W < 2:
        return {}
    multiproc = dist._world.mode == "multiproc"
    pl = planner_for_group(group)
    rank = group.rank()
    store = group.store if multiproc else None
    agreed: Dict = {}
    forced = os.environ.get(_ENV_FORCE)
    for op, nbytes, reduce_kind in entries:
        bucket = probe.bucket_bytes(max(int(nbytes), 1))
        tkey = (op, bucket, reduce_kind)
        hit = _TABLE.get(tkey)
        if hit is not None and hit["world"] == W:
            agreed[tkey] = hit["alg"]
            continue
        if multiproc:
            alg, source = _choose_no_probe(pl, op, nbytes, reduce_kind)
        else:
            alg, source = pl.choose(op, nbytes, reduce_kind, "driver")
        if store is not None and W > 1:
            # rank 0's choice is adopted by unforced ranks (per-host
            # probe caches may disagree; frame of reference is rank 0,
            # as on the eager p2p plane) — a LOCAL force is operator
            # intent and is kept, so skew is diagnosed, not laundered
            key = f"tracedalg/{op}/{bucket}/{reduce_kind}"
            if rank == 0:
                # one row per (op, bucket, kind) for the life of the
                # incarnation-scoped store; reclaimed with it
                store.set(key, f"{alg}".encode())
            else:
                store.wait([key], group.timeout)
                published = store.get(key).decode()
                if not forced:
                    alg, source = published, "agreed"
            eqns = _plan_eqns(pl, op, alg, W, bucket, reduce_kind)
            from ..store import PrefixStore

            agree_entry(
                PrefixStore(_AGREE_PREFIX, store), rank, W,
                _AGREE_SEQ[0], op=op, bucket=bucket,
                reduce_kind=reduce_kind, eqns=eqns, timeout=timeout,
            )
            # advance only after success: a timed-out round (peer
            # joining mid-agreement) retries under the same key
            _AGREE_SEQ[0] += 1
        _TABLE[tkey] = {"alg": alg, "world": W, "source": source}
        agreed[tkey] = alg
    return agreed


def prepare_for_params(group, params, *, zero_update: bool = False,
                       timeout: Optional[float] = None) -> Dict:
    """Derive the DDP/ZeRO step's bucket set from a param tree and
    prepare it: per-leaf all_reduce(avg) for the hook path, plus the
    reduce_scatter/all_gather halves of the sharded weight update."""
    from torch.utils import _pytree as pytree

    W = group.size()
    entries = []
    seen = set()
    for leaf in pytree.tree_leaves(params):
        if getattr(leaf, "ndim", 0) < 1:
            continue
        nbytes = int(leaf.numel()) * leaf.element_size()
        for op, per_rank in (
            ("all_reduce", nbytes),
            *(
                (
                    ("reduce_scatter", nbytes),
                    ("all_gather", max(nbytes // W, 1)),
                )
                if zero_update
                else ()
            ),
        ):
            kind = "avg" if op in ("all_reduce", "reduce_scatter") else "sum"
            b = probe.bucket_bytes(max(per_rank, 1))
            if (op, b, kind) in seen:
                continue
            seen.add((op, b, kind))
            entries.append((op, per_rank, kind))
    return prepare(group, entries, timeout=timeout)


# ---------------------------------------------------------------------------
# trace side: pure dispatch
# ---------------------------------------------------------------------------

_DISPATCHING = threading.local()


def dispatching() -> bool:
    """True while a seam here dispatches: the eager planner
    (`plan.maybe_lower`) then leaves the collectives it issues alone."""
    return getattr(_DISPATCHING, "depth", 0) > 0


@contextlib.contextmanager
def _seam():
    _DISPATCHING.depth = getattr(_DISPATCHING, "depth", 0) + 1
    try:
        yield
    finally:
        _DISPATCHING.depth -= 1


def _axis_size(axis_name: str, x) -> int:
    """The axis's W: the entered multiproc mesh's axis size, else the rank
    dim the stacked tensor holds."""
    from .. import mesh as _mesh

    b = _mesh.axis_binding(axis_name)
    return b.size if b is not None else int(x.shape[0])


def _row_bytes(x) -> int:
    """One rank's payload bytes of a rank-stacked tensor."""
    return max(int(x[0].numel()) * x.element_size(), 1) if x.dim() else x.element_size()


def _choose_traced(op: str, nbytes: int, reduce_kind: str, world: int,
                   group=None, warn_missing: bool = True) -> Optional[str]:
    """The trace-time choice ladder: force env → agreed table → the
    group planner's (trace-safe) cache lookup → stock (None), warning
    once per (op, bucket) when the planner is on but nothing was
    agreed.  Pure host-side python over static shape info — no store
    ops, no probes."""
    on = enabled(group)
    forced = os.environ.get(_ENV_FORCE) if on else None
    if forced and driver.supports(op, forced, world, reduce_kind):
        return forced
    entry = lookup(op, nbytes, reduce_kind)
    if entry is not None and entry["world"] == world:
        alg = schedules.EXEC_VARIANTS.get(entry["alg"], entry["alg"])
        if driver.supports(op, alg, world, reduce_kind):
            return alg
    if group is not None and on:
        from .. import distributed as dist

        if dist._world.mode != "multiproc":
            # driver (single-controller) mode: consult the group's
            # planner only if one was already built on the host (by
            # prepare() or an eager dispatch) — constructing it here
            # would run topology detection inside the trace. choose()
            # under tracing returns cache hits or the structural default
            # WITHOUT probing.
            pl = getattr(group, "_collective_planner", None)
            if pl is not None:
                alg, _src = pl.choose(op, nbytes, reduce_kind, "driver")
                return alg if alg != "onepass" else None
    if on and warn_missing and entry is None:
        bucket = probe.bucket_bytes(max(int(nbytes), 1))
        wkey = (op, bucket, reduce_kind)
        if wkey not in _WARNED:
            _WARNED.add(wkey)
            warnings.warn(
                f"plan.traced: no agreed schedule for {op} bucket "
                f"{bucket}B ({reduce_kind}) — taking the stock collective. "
                "Call plan.traced.prepare() (or prepare_for_params()) "
                "on the host before running this step to probe and "
                "agree a schedule for this shape bucket.",
                RuntimeWarning,
                stacklevel=3,
            )
    return None


_OPS = {"sum": "SUM", "avg": "AVG", "max": "MAX", "min": "MIN"}


def all_reduce(x, axis_name: str, *, reduce_kind: str = "sum", group=None,
               warn_missing: bool = True, replica: bool = False):
    """All-reduce of the rank-stacked x over `axis_name` through the agreed
    schedule table; the stock `nn.functional.all_reduce` when nothing is
    agreed. `replica=True` returns the one value every rank holds (the
    rank dim dropped), as `nn.functional`'s replica form."""
    from ..nn import functional as nnf
    from ..types import ReduceOp

    W = _axis_size(axis_name, x)
    alg = (_choose_traced("all_reduce", _row_bytes(x), reduce_kind, W, group, warn_missing)
           if W > 1 else None)
    with _seam():
        if alg in (None, "onepass"):
            return nnf.all_reduce(x, ReduceOp[_OPS[reduce_kind]], axis_name, replica=replica)
        out = driver.body_for("all_reduce", alg, W, axis_name, reduce_kind)(x)
    return out[0] if replica else out


def _ring_parts(x, axis_name: str, W: int):
    """Every rank's block, gathered by the decomposed ring: (n, W, *s)."""
    return driver.body_for("all_gather", "ring", W, axis_name)(x)


def all_gather(x, axis_name: str, *, dim: int = 0, tiled: bool = True, group=None,
               warn_missing: bool = True, replica: bool = False):
    """All-gather of the rank-stacked x along local dim `dim`; a ring
    choice runs as the W-1 neighbour shifts (pure data movement, bitwise
    the one-shot gather) unless `TDX_PLANNER_OVERLAP=0` pins the one-shot
    gather back."""
    from ..nn import functional as nnf

    W = _axis_size(axis_name, x)
    alg = (_choose_traced("all_gather", _row_bytes(x), "sum", W, group, warn_missing)
           if W > 1 else None)
    with _seam():
        if alg != "ring" or not overlap_enabled():
            return nnf.all_gather(x, axis_name, dim, tiled, replica=replica)
        chunks = _ring_parts(x, axis_name, W)  # (n, W, *s), rank-ordered
    d = dim % (x.dim() - 1) if tiled else dim % x.dim()
    parts = chunks.unbind(1)
    out = torch.cat(parts, d + 1) if tiled else torch.stack(parts, d + 1)
    return out[0] if replica else out


def reduce_scatter(flat, axis_name: str, *, reduce_kind: str = "sum", group=None,
                   warn_missing: bool = True):
    """Reduce-scatter of the rank-stacked flat (n, W*k) payloads to each
    rank's (n, k) chunk (the ZeRO grad-reduction wire shape)."""
    from ..nn import functional as nnf

    W = _axis_size(axis_name, flat)
    alg = (_choose_traced("reduce_scatter", _row_bytes(flat), reduce_kind, W, group,
                          warn_missing) if W > 1 else None)
    with _seam():
        if alg not in (None, "onepass"):
            return driver.body_for("reduce_scatter", alg, W, axis_name, reduce_kind)(
                flat.reshape(flat.shape[0], W, -1))
        out = nnf.reduce_scatter(flat, axis_name, 0)
    return out / W if reduce_kind == "avg" else out


def all_gather_matmul(x_local, w, axis_name: str, *, group=None,
                      out_dtype=torch.float32):
    """``all_gather(x_local, dim=0, tiled=True) @ w`` into one replica:
    x_local (n, m, k) the ranks' row blocks, w (k, o) replicated, the
    product in `out_dtype`. With a ring choice each landed chunk is
    multiplied as it arrives: CHUNK-exact (bitwise the concatenation of
    per-chunk products); against the one-shot gather-then-matmul it is
    allclose, not necessarily bitwise (a (W*m, k) and an (m, k) product
    may block the within-row sum differently). The one-shot gather when
    the planner declines, the world is trivial, or
    `TDX_PLANNER_OVERLAP=0`."""
    from ..nn import functional as nnf

    W = _axis_size(axis_name, x_local)
    alg = (_choose_traced("all_gather", _row_bytes(x_local), "sum", W, group,
                          warn_missing=False) if W > 1 else None)
    wf = w.to(out_dtype)
    with _seam():
        if W < 2 or alg != "ring" or not overlap_enabled():
            full = nnf.all_gather(x_local, axis_name, 0, replica=True)
            return full.to(out_dtype) @ wf
        chunks = _ring_parts(x_local, axis_name, W)[0]  # (W, m, k)
    return torch.cat([c.to(out_dtype) @ wf for c in chunks.unbind(0)], 0)


def on_group(op: str, x, group, stock: Callable, *, reduce_kind: str = "sum",
             warn_missing: bool = False):
    """A `ProcessGroup` call site through the seam: ``x`` the group's
    rank-stacked rows as `distributed` holds them (all_reduce (n, *s),
    all_gather (n, *s) -> (n, W, *s), reduce_scatter (n, W, *s) ->
    (n, *s)). With a chosen ring/rhd schedule the body runs over the
    group's ranks (an entered `DeviceMesh.from_group` in multiproc mode);
    otherwise `stock()` — the call site's own collective, so the planner
    off changes nothing."""
    from ..mesh import DeviceMesh

    W = group.size()
    alg = _choose_traced(op, _row_bytes(x), reduce_kind, W, group, warn_missing) if W > 1 \
        else None
    if alg in (None, "onepass") or (op == "all_gather" and not overlap_enabled()):
        return stock()
    mesh = DeviceMesh.from_group(group, driver.AXIS)
    with _seam(), mesh, torch.no_grad():
        return driver.body_for(op, alg, W, driver.AXIS, reduce_kind)(x)
