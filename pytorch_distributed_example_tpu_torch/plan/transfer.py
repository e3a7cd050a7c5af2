"""KV-migration transfer schedules — the planner's p2p plane applied
to DISAGGREGATED SERVING (`serve/disagg/`).

A finished prefill's paged KV blocks must move from the prefill pool's
mesh to the decode pool's mesh. The bytes are big (every layer's K/V —
plus scale planes for int8 pools — for every prompt block), the two
pools have INDEPENDENT widths, and migrations contend with live decode
traffic for the same links — exactly the regime "The Big Send-off"
(arxiv 2504.18658) synthesizes schedules for. This module emits the
same deterministic `Plan`/`Round`/`Step` artifact the collective
planner emits (`plan/schedules.py`), so migrations inherit the whole
existing machinery for free: the executor can walk rounds literally on
the multiproc p2p plane, the schedule verifier fingerprints every
round (`Round.descriptor()` hashes the WHOLE round), and
`Plan.artifact()` dumps a stable JSON-able trace for offline
inspection.

Shape of the schedule: the migration payload is an ordered span of
`n_blocks` prefix blocks, cut into `chunk_blocks`-sized CHUNKS (the
the migration-chunking knob — smaller chunks interleave better
with decode steps, bigger chunks amortize framing). Ranks are numbered
over the UNION gang — prefill ranks `[0, P)`, decode ranks
`[P, P + D)` — and each round ships one chunk per DISJOINT
(src, dst) link: within a round no prefill rank sends twice and no
decode rank receives twice, so a round's chunks genuinely overlap on
the wire. Chunk `c` rides link `(c % P → P + c % D)`; with
`L = min(P, D)` links active per round, consecutive chunks in a round
hit distinct sources AND distinct destinations, and the round count is
`ceil(n_chunks / L)` — the widths the two pools were sized with decide
the migration's critical path, not the block count alone.

The in-process disagg router (`serve/disagg/router.py`) uses the same
plan as its PUBLICATION ORDER: chunks land in the store in
round-major, link-minor order, so the single-process deterministic
tests and the multiproc plane execute byte-identical sequences.

A copy of the reference's `plan/transfer.py`.
"""

from __future__ import annotations

from typing import Iterator, Tuple

from .schedules import Plan, Round, Step

__all__ = ["schedule_migration", "chunk_spans"]


def schedule_migration(
    n_blocks: int,
    prefill_world: int,
    decode_world: int,
    chunk_blocks: int = 4,
) -> Plan:
    """Deterministic transfer plan moving `n_blocks` paged KV blocks
    from a `prefill_world`-wide pool to a `decode_world`-wide pool in
    `chunk_blocks`-sized chunks. Offsets/lengths are in BLOCKS (the
    migration payload's natural unit); the executor scales them by the
    per-block byte size of the pool tree it is moving."""
    if prefill_world < 1 or decode_world < 1:
        raise ValueError(
            f"pool worlds must be >= 1, got prefill={prefill_world} "
            f"decode={decode_world}"
        )
    if chunk_blocks < 1:
        raise ValueError(f"chunk_blocks must be >= 1, got {chunk_blocks}")
    if n_blocks < 0:
        raise ValueError(f"n_blocks must be >= 0, got {n_blocks}")
    P, D = prefill_world, decode_world
    world = P + D
    links = min(P, D)
    n_chunks = (n_blocks + chunk_blocks - 1) // chunk_blocks
    rounds = []
    for r in range((n_chunks + links - 1) // links):
        per_rank: list = [[] for _ in range(world)]
        for c in range(r * links, min((r + 1) * links, n_chunks)):
            off = c * chunk_blocks
            length = min(chunk_blocks, n_blocks - off)
            src = c % P
            dst = P + (c % D)
            per_rank[src].append(Step("send", dst, off, length))
            per_rank[dst].append(Step("copy", src, off, length))
        rounds.append(
            Round("mig", r, tuple(tuple(s) for s in per_rank))
        )
    return Plan(
        op="kv_migrate",
        algorithm="chunked",
        world=world,
        nelems=n_blocks,
        pad=0,
        topology_key=f"prefill{P}xdecode{D}",
        rounds=tuple(rounds),
    )


def chunk_spans(plan: Plan) -> Iterator[Tuple[int, int, int, int, int]]:
    """Walk a migration plan's chunks in execution order — round-major,
    link-minor — yielding `(round, src, dst, block_off, n_blocks)`.
    The in-process router publishes chunk payloads in exactly this
    order; the p2p executor moves them in exactly this order: one
    sequence, two transports."""
    for rnd in plan.rounds:
        for rank, steps in enumerate(rnd.steps):
            for s in steps:
                if s.kind == "send":
                    yield (rnd.index, rank, s.peer, s.offset, s.length)
