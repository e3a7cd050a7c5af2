"""Execute a synthesized `Plan` over the direct p2p data plane.

The port of the reference's `plan/executor.py`, over the port's
`P2PPlane`: the buffer is a CPU torch tensor (bf16 included, which numpy
lacks), the folds are torch's, and the walk, its fault seam, its verifier
records and its sequence numbering are the reference's.

The executor walks the plan's rounds literally: for each round it fires
the `plan.step` fault point, records the round's canonical descriptor
into the schedule verifier (when one is armed), performs its sends, then
its receives. That ordering is the chaos contract:

* the fingerprint lands BEFORE any socket op, so a rank that dies inside
  round k has already agreed on rounds 0..k — the survivors' NEXT
  checkpoint (they record round k+1 before blocking in its recv) times
  out on the dead rank and raises `ScheduleMismatchError` naming it and
  its last recorded planner steps, instead of the survivors hanging in a
  recv that can never complete;
* an advisory `corrupt` rule at `plan.step` perturbs THIS rank's round
  descriptor, so the next checkpoint reports the first divergent planner
  step on EVERY rank (the injected-divergence drill for the planner
  path, mirroring `schedule.mismatch` for the dispatch path).

Reduction order is fixed by the plan (ring/tree order; `reduce_any`
folds in sorted-peer order regardless of wire arrival), so re-executing
the same plan on the same inputs is bitwise-identical — the whole-pass
retry story.

Routes: every execution must use a fresh `route` string (the caller
scopes it by group, collective sequence number, and retry attempt);
sequence numbers within the route are assigned by walking the plan, so
both ends of every pair count identically.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, Optional, Tuple

import torch

from .. import faults
from .schedules import Plan

__all__ = ["execute", "combine_for", "default_pipeline_chunks",
           "split_chunks"]

_ENV_PIPE = "TDX_PLAN_PIPELINE_CHUNKS"


def default_pipeline_chunks() -> int:
    """Sub-chunk count for pipelined rounds (the "ring_pipe" execution
    variant); >= 2 to overlap, env-tunable for the bench A/B."""
    try:
        return max(2, int(os.environ.get(_ENV_PIPE, "4")))
    except ValueError:
        return 4


def _send_recv_overlap(per_rank_steps) -> bool:
    """True when one rank both sends from and receives into overlapping
    buffer ranges within a single round."""
    sends = [
        (s.offset, s.offset + s.length)
        for s in per_rank_steps if s.kind == "send"
    ]
    recvs = [
        (s.offset, s.offset + s.length)
        for s in per_rank_steps if s.kind in ("copy", "reduce")
    ]
    return any(a < d and c < b for a, b in sends for c, d in recvs)


def split_chunks(offset: int, length: int, chunks: int):
    """Deterministic sub-chunk split of a [offset, offset+length) segment
    — both ends of a pair derive the identical split from the shared
    plan, so per-peer sequence numbers stay aligned. Short segments
    yield fewer (never empty) chunks."""
    chunks = min(max(int(chunks), 1), max(int(length), 1))
    base, rem = divmod(int(length), chunks)
    out = []
    off = int(offset)
    for i in range(chunks):
        n = base + (1 if i < rem else 0)
        if n <= 0:
            continue
        out.append((off, n))
        off += n
    return out


def combine_for(reduce_kind: str) -> Callable:
    """Elementwise fold for the plan's reduce steps. ``reduce_kind`` is
    the planner's canonical name: "sum" (also serving AVG — the caller
    divides at the end), "max", "min"."""
    return {
        "sum": torch.add,
        "max": torch.maximum,
        "min": torch.minimum,
    }[reduce_kind]


def execute(
    plan: Plan,
    rank: int,
    payload: torch.Tensor,
    plane,
    *,
    route: str,
    reduce_kind: str = "sum",
    average: bool = False,
    timeout: float = 60.0,
    verifier=None,
    to_global: Optional[Callable[[int], int]] = None,
    pipeline_chunks: int = 1,
) -> torch.Tensor:
    """Run ``plan`` as group-rank ``rank`` over ``plane``; returns this
    rank's result (all_reduce: full payload; all_gather: (W, n) stack;
    reduce_scatter: own chunk). ``payload`` is this rank's flat input
    (all_reduce: (n,); all_gather: (n,); reduce_scatter: (W*cs,) chunk
    list). ``to_global`` maps group ranks to the plane's global ranks
    (identity when the group IS the world).

    ``pipeline_chunks > 1`` pipelines each round: segments split into
    sub-chunks and the send of chunk i+1 overlaps the receive+reduce of
    chunk i (while this rank folds chunk i, chunk i+1's bytes are in
    flight and the peer is folding its own previous chunk — the
    planner's "ring_pipe" execution variant). Rounds containing a
    ``reduce_any`` step on ANY rank stay unpipelined — the decision is
    a function of the shared plan, so every rank splits identically and
    per-peer sequence numbers stay aligned; the round descriptor gains
    a ``|pipe{C}`` suffix so the schedule verifier catches a gang whose
    ranks disagree on chunking. Folding order within a segment is
    ascending offset either way, so pipelined results are BITWISE
    identical to unpipelined (pinned in tests/test_torch_planner.py)."""
    gmap = to_global if to_global is not None else (lambda r: r)
    combine = combine_for(reduce_kind)
    flat = torch.as_tensor(payload).detach().cpu().reshape(-1)
    dtype = flat.dtype

    if plan.op == "all_gather":
        buf = torch.zeros(plan.world * plan.nelems, dtype=dtype)
        if flat.numel() != plan.nelems:
            raise ValueError(
                f"all_gather payload {flat.numel()} != plan block {plan.nelems}"
            )
        buf[rank * plan.nelems:(rank + 1) * plan.nelems] = flat
    else:
        if flat.numel() > plan.nelems:
            raise ValueError(
                f"payload {flat.numel()} exceeds plan size {plan.nelems}"
            )
        buf = torch.zeros(plan.nelems, dtype=dtype)
        buf[: flat.numel()] = flat

    send_seq: Dict[int, int] = {}
    recv_seq: Dict[int, int] = {}

    def next_send(peer: int) -> int:
        s = send_seq.get(peer, 0)
        send_seq[peer] = s + 1
        return s

    def next_recv(peer: int) -> int:
        s = recv_seq.get(peer, 0)
        recv_seq[peer] = s + 1
        return s

    pipe = max(int(pipeline_chunks), 1)

    def fold(s, off, n):
        val = plane.recv(gmap(s.peer), route, 0, next_recv(s.peer), timeout)
        seg = buf[off:off + n]
        if s.kind == "copy":
            seg.copy_(val)
        else:
            combine(seg, val.to(dtype), out=seg)

    step_seq = 0
    for rnd in plan.rounds:
        desc = rnd.descriptor()
        # pipelining is decided from the WHOLE round (every rank sees
        # the same plan, so every rank splits — or does not — in
        # lockstep); reduce_any rounds (hier leader fan-in) keep the
        # one-frame-per-member contract, and a round where any rank's
        # send segment overlaps its recv segment must ship the send
        # before folding mutates the buffer (no current schedule does,
        # but the plan — not the synthesizer — is the contract here)
        pipelined = pipe > 1 and not any(
            s.kind == "reduce_any" for per in rnd.steps for s in per
        ) and not any(_send_recv_overlap(per) for per in rnd.steps)
        if pipelined:
            desc += f"|pipe{pipe}"
        # the fault seam fires before the fingerprint so an advisory
        # corrupt rule can perturb what gets recorded; generic actions
        # (error/hang/crash) fire here too — before any socket op of
        # this round, after full agreement on every earlier round
        rule = faults.fire(
            "plan.step", rank=rank, phase=rnd.phase, index=rnd.index,
            algorithm=plan.algorithm,
        )
        if rule is not None and rule.action == "corrupt":
            desc += "|<injected-divergence>"
        if verifier is not None:
            verifier.record(
                step_seq, f"plan.{plan.op}.{plan.algorithm}",
                (plan.nelems,), str(dtype), detail=desc,
            )
        step_seq += 1
        my = rnd.steps[rank]
        if pipelined:
            send_parts = [
                (s, split_chunks(s.offset, s.length, pipe))
                for s in my if s.kind == "send"
            ]
            recv_parts = [
                (s, split_chunks(s.offset, s.length, pipe))
                for s in my if s.kind in ("copy", "reduce")
            ]
            K = max(
                (len(p) for _, p in send_parts + recv_parts), default=0
            )
            for k in range(K + 1):
                # send chunk k first, THEN fold chunk k-1: the fold's
                # work happens while chunk k is on the wire
                for s, parts in send_parts:
                    if k < len(parts):
                        off, n = parts[k]
                        plane.send(
                            gmap(s.peer), route, 0, next_send(s.peer),
                            buf[off:off + n], timeout,
                        )
                if k >= 1:
                    for s, parts in recv_parts:
                        if k - 1 < len(parts):
                            off, n = parts[k - 1]
                            fold(s, off, n)
            continue
        for s in my:
            if s.kind == "send":
                plane.send(
                    gmap(s.peer), route, 0, next_send(s.peer),
                    buf[s.offset:s.offset + s.length], timeout,
                )
        for s in my:
            if s.kind in ("copy", "reduce"):
                fold(s, s.offset, s.length)
            elif s.kind == "reduce_any":
                # take contributions off the wire in arrival order
                # (latency), fold them in sorted-peer order (bitwise
                # determinism across retries)
                pending = {p: next_recv(p) for p in s.peers}
                got: Dict[int, torch.Tensor] = {}
                while pending:
                    cands = [(gmap(p), q) for p, q in pending.items()]
                    src_g, val = plane.recv_any(cands, route, 0, timeout)
                    src = next(
                        p for p in pending if gmap(p) == src_g
                    )
                    got[src] = val
                    del pending[src]
                seg = buf[s.offset:s.offset + s.length]
                for p in sorted(got):
                    combine(seg, got[p].to(dtype), out=seg)

    if plan.op == "all_reduce":
        out = buf[: flat.numel()]
        if average:
            out = out / plan.world
        return out
    if plan.op == "all_gather":
        return buf.reshape(plan.world, plan.nelems)
    # reduce_scatter: own chunk
    cs = plan.nelems // plan.world
    out = buf[rank * cs:(rank + 1) * cs]
    if average:
        out = out / plan.world
    return out
