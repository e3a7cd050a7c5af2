"""Topology descriptor for the collective planner.

A `Topology` is the planner's view of WHERE the ranks of a process group
live: which ranks share a host (fast intra-host paths) and which pairs
cross a host boundary (the slow links a hierarchical schedule minimizes
traffic over). It is inferred from rendezvous metadata — in multiproc
mode from the p2p-plane endpoints every rank publishes in the store
(`p2p.py` `ep/<rank>` keys carry the advertised host), in driver mode
from each device's owning process — and can be overridden with
`TDX_TOPOLOGY` ("0,0,1,1": host id per group rank) for testing or for
fabrics the heuristics cannot see.

`key()` is the stable string the probe cache is keyed by: two gangs with
the same world size, host grouping shape, and device platform share
measured algorithm timings; anything else must not (PCCL, arxiv
2606.07019: schedules are per-topology artifacts).

A copy of the reference's `plan/topology.py`; `detect` reads the port's
`DeviceMesh` and, with no p2p plane in the port yet, groups the ranks of
a multiproc gang one to a host.
"""

from __future__ import annotations

import os
import pickle
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

__all__ = ["Topology", "detect", "from_env"]

_ENV = "TDX_TOPOLOGY"


@dataclass(frozen=True)
class Topology:
    """Host grouping of a group's ranks.

    ``hosts`` is a tuple of tuples of GROUP ranks; every rank appears in
    exactly one host group, groups are ordered by their smallest member.
    ``platform`` tags the probe-cache key (cpu/tpu timings never mix).
    """

    world: int
    hosts: Tuple[Tuple[int, ...], ...]
    platform: str = "cpu"

    def __post_init__(self):
        seen = sorted(r for h in self.hosts for r in h)
        if seen != list(range(self.world)):
            raise ValueError(
                f"topology hosts {self.hosts} do not partition "
                f"0..{self.world - 1}"
            )

    @property
    def n_hosts(self) -> int:
        return len(self.hosts)

    @property
    def multi_host(self) -> bool:
        return len(self.hosts) > 1

    def host_of(self, rank: int) -> int:
        for i, h in enumerate(self.hosts):
            if rank in h:
                return i
        raise ValueError(f"rank {rank} not in topology {self.hosts}")

    def leaders(self) -> List[int]:
        """First (lowest) rank of each host group — the hierarchical
        schedule's per-host aggregation points."""
        return [h[0] for h in self.hosts]

    def key(self) -> str:
        """Probe-cache key: world + host-group shape + platform. Group
        SIZES (sorted) rather than exact memberships: two gangs with
        the same shape see the same link structure, and elastic rank
        reshuffles within a shape must reuse the table."""
        sizes = "x".join(str(len(h)) for h in sorted(self.hosts, key=len))
        return f"w{self.world}/h{sizes}/{self.platform}"


def from_env(world: int, platform: str = "cpu") -> Optional[Topology]:
    """TDX_TOPOLOGY override: comma-separated host id per group rank."""
    raw = os.environ.get(_ENV)
    if not raw:
        return None
    ids = [s.strip() for s in raw.split(",")]
    if len(ids) != world:
        raise ValueError(
            f"{_ENV}={raw!r} names {len(ids)} ranks but the group has "
            f"{world}"
        )
    groups: dict = {}
    for r, h in enumerate(ids):
        groups.setdefault(h, []).append(r)
    hosts = tuple(
        tuple(v) for v in sorted(groups.values(), key=lambda g: g[0])
    )
    return Topology(world, hosts, platform)


def _group_by(world: int, host_ids: Sequence[object], platform: str) -> Topology:
    groups: dict = {}
    for r in range(world):
        groups.setdefault(host_ids[r], []).append(r)
    hosts = tuple(
        tuple(v) for v in sorted(groups.values(), key=lambda g: g[0])
    )
    return Topology(world, hosts, platform)


def from_plane_endpoints(store, global_ranks: Sequence[int], timeout: float,
                         platform: str) -> Topology:
    """Multiproc inference: every rank published `ep/<rank>` (pickled
    `(host, port)` or the b"none" tombstone) in the p2p plane's store
    namespace during init — the advertised host IS the rendezvous
    metadata for "which machine is this rank on". Opted-out ranks
    (b"none") are grouped alone: without an advertised address the safe
    assumption is a cross-host link."""
    hosts: List[object] = []
    for i, gr in enumerate(global_ranks):
        key = f"ep/{gr}"
        store.wait([key], timeout)
        raw = store.get(key)
        if raw == b"none":
            hosts.append(("opted-out", gr))
        else:
            hosts.append(pickle.loads(raw)[0])
    return _group_by(len(global_ranks), hosts, platform)


def from_devices(devices, platform: str) -> Topology:
    """Driver-mode inference: group the mesh's devices by the process
    that owns them (multi-host driver topologies expose this as
    `device.process_index`; a single host collapses to one group)."""
    ids = [getattr(d, "process_index", 0) for d in devices]
    return _group_by(len(ids), ids, platform)


def detect(group) -> Topology:
    """Best topology for a ProcessGroup: env override, else mode-specific
    inference. Deterministic across ranks (env + store + mesh metadata
    are all rank-agreed inputs)."""
    from .. import distributed as dist

    world = group.size()
    platform = _platform(group)
    try:
        env = from_env(world, platform)
    except ValueError:
        # the override describes a different gang (usually the full
        # world, while this is a subgroup): ignore it here and infer —
        # a global env pin must not fail subgroup collectives
        env = None
    if env is not None:
        return env
    if dist._world.mode == "multiproc":
        # the port has no p2p plane yet (ROADMAP.md, Queue 1 item 4), so
        # no rank has published an endpoint: each rank is its own host,
        # the safe assumption for an unknown link
        return _group_by(world, list(range(world)), platform)
    return from_devices(group.mesh.device_list(), platform)


def _platform(group) -> str:
    try:
        d = group.mesh.device_list()[0]
        return "gpu" if d.type == "cuda" else str(d.type).lower()
    except Exception:  # pragma: no cover - exotic mesh shims
        return "cpu"
