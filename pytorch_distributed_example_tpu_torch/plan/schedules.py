"""Synthesized collective schedules: ring / tree / hierarchical.

A `Plan` is the deterministic artifact the planner emits for one
`(op, payload, world, topology)` choice: an ordered list of `Round`s,
each holding EVERY rank's steps for that round. Determinism is the
contract everything else leans on —

* the p2p executor (`executor.py`) walks the rounds literally, so two
  attempts of the same plan move the same bytes in the same order and a
  whole-pass retry replays bitwise;
* the schedule verifier fingerprints each round's `descriptor()` —
  identical on every rank by construction (it hashes the WHOLE round,
  not the local steps), so per-rank step-count asymmetry (a hierarchical
  leader does more work than a member) cannot desynchronize the
  count-based checkpoints;
* `artifact()` is a stable JSON-able dict, suitable for on-disk dumps
  and cross-rank comparison.

Algorithms ("The Big Send-off" arxiv 2504.18658 synthesizes exactly this
family): flat ring (bandwidth-optimal, 2(W-1) rounds), recursive
halving/doubling tree (latency-optimal, 2·log2 W rounds, power-of-two
worlds), and hierarchical intra-host-reduce → cross-host-ring →
intra-host-broadcast for multi-host topologies (cross-host bytes shrink
from (W-1)/W to (H-1)/H of payload per slow link).

A copy of the reference's `plan/schedules.py`: the same plans, byte for
byte the same artifacts and fingerprints.
"""

from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass, field
from typing import List, Tuple

from .topology import Topology

__all__ = [
    "Step", "Round", "Plan", "synthesize", "ALGORITHMS", "plan_divisor",
]

# step kinds: "send" ships buf[off:off+len] to `peer`; "copy" receives
# into buf[off:]; "reduce" receives and combines into buf[off:];
# "reduce_any" receives one full payload from EACH peer in `peers`
# (any arrival order — the fold replays in sorted peer order, so the
# result bits are order-independent).


@dataclass(frozen=True)
class Step:
    kind: str
    peer: int = -1
    offset: int = 0
    length: int = 0
    peers: Tuple[int, ...] = ()

    def spec(self) -> list:
        return [self.kind, self.peer, self.offset, self.length,
                list(self.peers)]


@dataclass(frozen=True)
class Round:
    phase: str
    index: int
    steps: Tuple[Tuple[Step, ...], ...]  # steps[rank] = that rank's steps
    _desc: str = field(default="", compare=False)

    def descriptor(self) -> str:
        """Canonical round fingerprint — derived from the whole round, so
        every rank records the identical string."""
        if self._desc:
            return self._desc
        h = hashlib.sha256(
            json.dumps(
                [[s.spec() for s in per_rank] for per_rank in self.steps]
            ).encode()
        ).hexdigest()[:12]
        d = f"{self.phase}#{self.index}|{h}"
        object.__setattr__(self, "_desc", d)
        return d


@dataclass(frozen=True)
class Plan:
    op: str            # "all_reduce" | "all_gather" | "reduce_scatter"
    algorithm: str     # "ring" | "rhd" | "hier"
    world: int
    nelems: int        # padded element count the schedule was built for
    pad: int           # trailing pad elements (strip on output)
    topology_key: str
    rounds: Tuple[Round, ...]

    def steps_for(self, rank: int) -> List[Tuple[Round, Tuple[Step, ...]]]:
        return [(r, r.steps[rank]) for r in self.rounds]

    def artifact(self) -> dict:
        """Deterministic JSON-able schedule artifact."""
        return {
            "op": self.op,
            "algorithm": self.algorithm,
            "world": self.world,
            "nelems": self.nelems,
            "pad": self.pad,
            "topology": self.topology_key,
            "rounds": [
                {
                    "phase": r.phase,
                    "index": r.index,
                    "descriptor": r.descriptor(),
                    "steps": [
                        [s.spec() for s in per_rank] for per_rank in r.steps
                    ],
                }
                for r in self.rounds
            ],
        }

    def fingerprint(self) -> str:
        return hashlib.sha256(
            json.dumps(self.artifact(), sort_keys=True).encode()
        ).hexdigest()


def _is_pow2(n: int) -> bool:
    return n >= 2 and (n & (n - 1)) == 0


def plan_divisor(algorithm: str, world: int, topo: Topology) -> int:
    """Element-count divisibility the algorithm's chunking needs; the
    planner pads payloads up to a multiple of this."""
    if algorithm == "hier":
        return max(1, len(topo.leaders()))
    return world


def _ring_pairs_steps(world, send_chunk, recv_chunk, kind, cs):
    """One ring round: rank r sends chunk send_chunk(r) to r+1 and
    receives chunk recv_chunk(r) from r-1 (kind = copy|reduce)."""
    per_rank = []
    for r in range(world):
        per_rank.append((
            Step("send", (r + 1) % world, send_chunk(r) * cs, cs),
            Step(kind, (r - 1) % world, recv_chunk(r) * cs, cs),
        ))
    return tuple(per_rank)


def _ring_all_reduce(world: int, nelems: int) -> Tuple[Round, ...]:
    cs = nelems // world
    rounds = []
    for s in range(world - 1):  # reduce-scatter phase
        rounds.append(Round("rs", s, _ring_pairs_steps(
            world,
            lambda r, s=s: (r - s) % world,
            lambda r, s=s: (r - s - 1) % world,
            "reduce", cs,
        )))
    for s in range(world - 1):  # all-gather phase
        rounds.append(Round("ag", s, _ring_pairs_steps(
            world,
            lambda r, s=s: (r + 1 - s) % world,
            lambda r, s=s: (r - s) % world,
            "copy", cs,
        )))
    return tuple(rounds)


def _ring_reduce_scatter(world: int, nelems: int) -> Tuple[Round, ...]:
    # input is the W-chunk list; rank r ends holding reduced chunk r
    cs = nelems // world
    rounds = []
    for s in range(world - 1):
        rounds.append(Round("rs", s, _ring_pairs_steps(
            world,
            lambda r, s=s: (r - s - 1) % world,
            lambda r, s=s: (r - s - 2) % world,
            "reduce", cs,
        )))
    return tuple(rounds)


def _ring_all_gather(world: int, nelems: int) -> Tuple[Round, ...]:
    # buffer is the (W * nelems) gather target; block b = rank b's data
    rounds = []
    for s in range(world - 1):
        rounds.append(Round("ag", s, _ring_pairs_steps(
            world,
            lambda r, s=s: (r - s) % world,
            lambda r, s=s: (r - s - 1) % world,
            "copy", nelems,
        )))
    return tuple(rounds)


def _rhd_all_reduce(world: int, nelems: int) -> Tuple[Round, ...]:
    """Recursive halving (reduce-scatter) + doubling (all-gather)."""
    assert _is_pow2(world), "rhd needs a power-of-two world"
    L = world.bit_length() - 1
    off = [0] * world
    seg = [nelems] * world
    rounds = []
    for k in range(L):
        m = 1 << k
        per_rank = []
        for r in range(world):
            half = seg[r] // 2
            hi = (r >> k) & 1
            keep = off[r] + (half if hi else 0)
            send = off[r] + (0 if hi else half)
            per_rank.append((
                Step("send", r ^ m, send, half),
                Step("reduce", r ^ m, keep, half),
            ))
        for r in range(world):
            half = seg[r] // 2
            off[r] += half if ((r >> k) & 1) else 0
            seg[r] = half
        rounds.append(Round("rs", k, tuple(per_rank)))
    for k in reversed(range(L)):
        m = 1 << k
        per_rank = []
        new_off = list(off)
        for r in range(world):
            p = r ^ m
            per_rank.append((
                Step("send", p, off[r], seg[r]),
                Step("copy", p, off[p], seg[p]),
            ))
            new_off[r] = min(off[r], off[p])
        off = new_off
        seg = [s * 2 for s in seg]
        rounds.append(Round("ag", k, tuple(per_rank)))
    return tuple(rounds)


def _hier_all_reduce(world: int, nelems: int, topo: Topology) -> Tuple[Round, ...]:
    """intra-host reduce → cross-host ring over the leaders → intra-host
    broadcast. Leaders use `reduce_any`: member contributions are taken
    in ARRIVAL order off the wire (the p2p plane's recv_any) but folded
    in sorted-peer order, so latency is first-come while bits stay
    deterministic."""
    leaders = topo.leaders()
    H = len(leaders)
    rounds = []
    # phase 1: members ship the full payload to their host leader
    per_rank: List[Tuple[Step, ...]] = [()] * world
    for h in topo.hosts:
        lead, members = h[0], h[1:]
        for m in members:
            per_rank[m] = (Step("send", lead, 0, nelems),)
        if members:
            per_rank[lead] = (
                Step("reduce_any", -1, 0, nelems, tuple(members)),
            )
    rounds.append(Round("intra_reduce", 0, tuple(per_rank)))
    # phase 2: leaders ring-all-reduce among themselves
    if H > 1:
        for sub in _ring_all_reduce(H, nelems):
            per_rank = [()] * world
            for vr, steps in enumerate(sub.steps):
                per_rank[leaders[vr]] = tuple(
                    Step(s.kind, leaders[s.peer], s.offset, s.length)
                    for s in steps
                )
            rounds.append(Round(f"xhost_{sub.phase}", sub.index,
                                tuple(per_rank)))
    # phase 3: leaders broadcast the result back to their members
    per_rank = [()] * world
    for h in topo.hosts:
        lead, members = h[0], h[1:]
        if members:
            per_rank[lead] = tuple(
                Step("send", m, 0, nelems) for m in members
            )
            for m in members:
                per_rank[m] = (Step("copy", lead, 0, nelems),)
    rounds.append(Round("intra_bcast", 0, tuple(per_rank)))
    return tuple(rounds)


def synthesize(op: str, algorithm: str, world: int, nelems: int,
               topo: Topology) -> Plan:
    """Build the Plan for (op, algorithm, world, topology).

    ``nelems`` is the RAW payload: the flat per-rank element count for
    all_reduce (padded here to the algorithm's chunk divisor and
    recorded in ``plan.pad``), the per-rank block length for all_gather,
    and the per-chunk length for reduce_scatter (the schedule then
    covers the W-chunk input list) — the latter two need no padding."""
    if op == "all_reduce":
        padded = pad_for(algorithm, world, nelems, topo)
        if algorithm == "ring":
            rounds = _ring_all_reduce(world, padded)
        elif algorithm == "rhd":
            rounds = _rhd_all_reduce(world, padded)
        elif algorithm == "hier":
            rounds = _hier_all_reduce(world, padded, topo)
        else:
            raise ValueError(f"unknown all_reduce algorithm {algorithm!r}")
        return Plan(op, algorithm, world, padded, padded - nelems,
                    topo.key(), rounds)
    if op == "all_gather":
        if algorithm != "ring":
            raise ValueError(f"unknown all_gather algorithm {algorithm!r}")
        n = max(int(nelems), 1)
        return Plan(op, algorithm, world, n, 0, topo.key(),
                    _ring_all_gather(world, n))
    if op == "reduce_scatter":
        if algorithm != "ring":
            raise ValueError(
                f"unknown reduce_scatter algorithm {algorithm!r}"
            )
        cs = max(int(nelems), 1)
        return Plan(op, algorithm, world, world * cs, 0, topo.key(),
                    _ring_reduce_scatter(world, world * cs))
    raise ValueError(f"unplannable op {op!r}")


def pad_for(algorithm: str, world: int, nelems: int, topo: Topology) -> int:
    """Padded element count for a raw payload size."""
    div = plan_divisor(algorithm, world, topo)
    n = max(int(nelems), 1)
    rem = n % div
    return n if rem == 0 else n + div - rem


# algorithm menu per op; the p2p plane executes any of these, the driver
# (XLA) plane additionally knows "onepass" (the stock one-shot lowering)
ALGORITHMS = {
    "all_reduce": ("ring", "rhd", "hier"),
    "all_gather": ("ring",),
    "reduce_scatter": ("ring",),
}

# execution VARIANTS: same synthesized schedule, different executor
# behavior — "ring_pipe" walks the ring plan with chunk pipelining
# (executor.py pipeline_chunks: send of chunk i+1 overlaps the fold of
# chunk i). The planner treats a variant as a first-class p2p-plane
# candidate; `plan_for` synthesizes the BASE schedule.
EXEC_VARIANTS = {"ring_pipe": "ring"}

__all__.append("EXEC_VARIANTS")
