"""`CollectivePlanner`: probe-driven algorithm choice + plan caching.

The port of the reference's `plan/planner.py`, with the same order of
choice; "inside a trace" is `traceguard.under_tracing()` (a `torch.func`
transform or `torch.compile`).

One planner per (process group, topology). `choose()` answers "which
algorithm for this (op, per-rank payload)" from, in priority order:

1. `TDX_PLANNER_FORCE=<alg>` — operator pin, no probing (benches, chaos
   drills, and A/B runs use this to hold the variable fixed);
2. the probe cache (on-disk artifact keyed by topology — `probe.py`);
3. a fresh probe sweep over the candidates (persisted for next time);
4. when probing is impossible (no driver mesh — the multiproc p2p plane
   is not probed), a deterministic structural default:
   hierarchical for multi-host topologies, ring otherwise.

`plan_for()` synthesizes (and caches) the schedule `Plan` for the chosen
algorithm; `emit_artifact()` dumps its deterministic JSON next to the
run when `TDX_PLANNER_ARTIFACT_DIR` is set.
"""

from __future__ import annotations

import json
import logging
import os
from typing import Dict, Optional, Tuple

from . import driver, probe, schedules
from .topology import Topology

logger = logging.getLogger(__name__)

__all__ = ["CollectivePlanner"]

_ENV_FORCE = "TDX_PLANNER_FORCE"
_ARTIFACT_DIR = "TDX_PLANNER_ARTIFACT_DIR"


class CollectivePlanner:
    def __init__(
        self,
        topology: Topology,
        *,
        mesh=None,
        axis: str = "",
        cache: Optional[probe.ProbeCache] = None,
        probe_fn=None,
    ):
        """``mesh``/``axis`` enable driver-plane probing; ``probe_fn``
        overrides the prober (tests inject synthetic timings)."""
        self.topology = topology
        self.world = topology.world
        self.mesh = mesh
        self.axis = axis
        self.cache = cache if cache is not None else probe.ProbeCache()
        self._probe_fn = probe_fn
        self._plans: Dict[Tuple, schedules.Plan] = {}
        self._choices: Dict[Tuple, Tuple[str, str]] = {}
        self.last_choice: Optional[Tuple[str, str, str]] = None

    # -- candidates --------------------------------------------------------

    def candidates(self, op: str, reduce_kind: str = "sum",
                   plane: str = "driver") -> Tuple[str, ...]:
        if plane == "driver":
            cands = driver.driver_candidates(op, self.world, reduce_kind)
        else:  # p2p plane: only synthesized schedules exist
            cands = tuple(
                a for a in schedules.ALGORITHMS.get(op, ())
                if a != "rhd" or (self.world & (self.world - 1)) == 0
            )
            if not self.topology.multi_host:
                # single-host hier degenerates to a star through one
                # leader; keep it only when there are hosts to layer over
                cands = tuple(a for a in cands if a != "hier")
            # execution variants ride AFTER their base (the structural
            # default — cands[0] — stays the plain schedule; a variant
            # only wins through a measured cache/probe row)
            cands += tuple(
                v for v, base in schedules.EXEC_VARIANTS.items()
                if base in cands and op == "all_reduce"
            )
        if reduce_kind not in ("sum", "avg") and op == "all_reduce":
            cands = tuple(a for a in cands if a != "ring" or plane != "driver")
        return cands

    # -- choice ------------------------------------------------------------

    def choose(self, op: str, per_rank_bytes: int,
               reduce_kind: str = "sum",
               plane: str = "driver") -> Tuple[str, str]:
        """(algorithm, source) for this op/payload; source is one of
        "force" | "cache" | "probe" | "default"."""
        forced = os.environ.get(_ENV_FORCE)
        cands = self.candidates(op, reduce_kind, plane)
        if forced:
            if forced in cands:
                self.last_choice = (op, forced, "force")
                return forced, "force"
            known = {"onepass"} | set(schedules.EXEC_VARIANTS) | {
                a for algs in schedules.ALGORITHMS.values() for a in algs
            }
            if forced not in known:
                raise ValueError(
                    f"{_ENV_FORCE}={forced!r} is not a planner algorithm "
                    f"(known: {sorted(known)})"
                )
            # a KNOWN algorithm that cannot carry THIS (op, reduce-op,
            # plane) — e.g. ring forced globally while DDP's param
            # verification issues all_reduce(MIN): fall through to the
            # normal choice instead of failing an unrelated collective
        if not cands:
            raise ValueError(f"no planner candidates for {op}")
        if len(cands) == 1:
            self.last_choice = (op, cands[0], "default")
            return cands[0], "default"
        bucket = probe.bucket_bytes(per_rank_bytes)
        key = (op, bucket, reduce_kind, plane)
        hit = self._choices.get(key)
        if hit is not None:
            self.last_choice = (op,) + hit
            return hit
        timings = self.cache.lookup(self.topology.key(), op, bucket, plane)
        # a cache row is usable when it covers every BASE algorithm:
        # execution variants (ring_pipe) without a measured row simply
        # are not selectable — discarding a complete pre-variant row
        # would silently revert a measured rhd/ring win to the
        # structural default
        required = {a for a in cands if a not in schedules.EXEC_VARIANTS}
        usable = timings is not None and required <= set(timings)
        if not usable:
            # no usable cache row and we are INSIDE a trace (the DDP comm
            # hook chooses per leaf inside the step's rank vmap): probing
            # would run host programs once per traced rank — take the
            # structural default WITHOUT memoizing, so a later eager
            # dispatch at this bucket still probes for real
            from .. import traceguard

            if plane == "driver" and traceguard.under_tracing():
                alg = cands[0]  # driver candidates lead with "onepass"
                self.last_choice = (op, alg, "default")
                return alg, "default"
        source = "cache"
        if not usable:
            # probe programs run on the DRIVER plane of a single-controller
            # process only; the multiproc plane prober is a no-op and
            # _agreed_plane_choice store-publishes rank 0's choice
            timings = self._probe(op, cands, bucket, reduce_kind, plane)
            source = "probe"
            if timings is None:  # probing impossible: structural default
                alg = "hier" if (
                    self.topology.multi_host and "hier" in cands
                ) else cands[0]
                self._choices[key] = (alg, "default")
                self.last_choice = (op, alg, "default")
                return alg, "default"
            self.cache.update(self.topology.key(), op, bucket, timings,
                              plane)
        alg = min(
            (a for a in cands if a in timings), key=lambda a: timings[a]
        )
        self._choices[key] = (alg, source)
        self.last_choice = (op, alg, source)
        return alg, source

    def _probe(self, op, cands, bucket, reduce_kind, plane):
        if self._probe_fn is not None:
            return self._probe_fn(op, cands, bucket, reduce_kind)
        if plane == "driver" and self.mesh is not None:
            return probe.probe_driver(
                self.mesh, self.axis, self.world, op, cands, bucket,
                reduce_kind,
            )
        return None

    def explain(self, op: str, per_rank_bytes: int,
                reduce_kind: str = "sum", plane: str = "driver") -> dict:
        """Introspection row for benches/debug endpoints."""
        alg, source = self.choose(op, per_rank_bytes, reduce_kind, plane)
        bucket = probe.bucket_bytes(per_rank_bytes)
        return {
            "op": op,
            "plane": plane,
            "algorithm": alg,
            "source": source,
            "bucket_bytes": bucket,
            "topology": self.topology.key(),
            "timings": self.cache.lookup(
                self.topology.key(), op, bucket, plane
            ),
        }

    # -- plans -------------------------------------------------------------

    def plan_for(self, op: str, algorithm: str, nelems: int) -> schedules.Plan:
        # execution variants (ring_pipe) share their base's schedule;
        # only the executor walk differs
        algorithm = schedules.EXEC_VARIANTS.get(algorithm, algorithm)
        key = (op, algorithm, int(nelems))
        plan = self._plans.get(key)
        if plan is None:
            plan = schedules.synthesize(
                op, algorithm, self.world, int(nelems), self.topology
            )
            self._plans[key] = plan
            self.emit_artifact(plan)
        return plan

    def emit_artifact(self, plan: schedules.Plan) -> Optional[str]:
        """Dump the deterministic schedule artifact when the operator
        asked for it (TDX_PLANNER_ARTIFACT_DIR)."""
        d = os.environ.get(_ARTIFACT_DIR)
        if not d:
            return None
        try:
            os.makedirs(d, exist_ok=True)
            path = os.path.join(
                d,
                f"{plan.op}-{plan.algorithm}-w{plan.world}-"
                f"n{plan.nelems}-{plan.fingerprint()[:12]}.json",
            )
            with open(path, "w") as f:
                json.dump(plan.artifact(), f, indent=1, sort_keys=True)
            return path
        except OSError:
            logger.warning("planner artifact dir %s not writable", d)
            return None
