"""Measured probes + the on-disk probe cache behind algorithm choice.

The port of the reference's `plan/probe.py`: `ProbeCache`, `bucket_bytes`
and `cache_path` are copies (the same JSON artifact, so the two packages
read each other's files), and `probe_driver` times the candidates' bodies
on the driver-mode stacked tensor: with CUDA events on the card,
`perf_counter` on the CPU. The artifact lives under `pytorch_distributed_
example_tpu_torch/` in the cache directory, apart from the reference's;
a file probed on another platform holds another topology key, so its
rows are never read for this gang (the stale-topology warning fires and
the gang is probed fresh).

The planner never hardcodes a winner: for each (op, payload-size bucket)
it times every candidate algorithm on the live gang (a short warmup +
timed sweep per candidate, `plan.probe` fault point per measurement) and
picks the argmin. Measurements persist in a JSON probe-cache artifact
keyed by the TOPOLOGY key (`topology.Topology.key()`), so a restarted
job on the same gang shape skips the sweep entirely.

Hygiene (the escape hatches a measured-choice system owes its
operators):

* `TDX_PLANNER_PROBE_CACHE=<path>` points the artifact somewhere else;
  setting it to the EMPTY string disables persistence (probe every
  process, write nothing);
* a cache file whose recorded topology keys no longer include the live
  gang's key warns ONCE per process (the table is stale for this
  topology — e.g. the gang grew, or moved to another platform) and fresh
  probes are taken and merged alongside the old keys;
* writes are atomic (tmp + rename) and merging, so concurrent ranks of
  one gang — who measure the same table — cannot tear the file.
"""

from __future__ import annotations

import json
import logging
import os
import tempfile
import time
from typing import Dict, Iterable, Optional

from .. import faults

logger = logging.getLogger(__name__)

__all__ = ["ProbeCache", "bucket_bytes", "cache_path", "probe_driver"]

_ENV_PATH = "TDX_PLANNER_PROBE_CACHE"
_ENV_ITERS = "TDX_PLANNER_PROBE_ITERS"
_ENV_WARMUP = "TDX_PLANNER_PROBE_WARMUP"
_VERSION = 1
_MIN_BUCKET = 1 << 10


def bucket_bytes(nbytes: int) -> int:
    """Power-of-4 size bucket (ceiling), floored at 1 KB — matches the
    bench sweep's ×4 size ladder so probe rows and bench rows align."""
    b = _MIN_BUCKET
    n = max(int(nbytes), 1)
    while b < n:
        b <<= 2
    return b


def probe_iters() -> int:
    return max(1, int(os.environ.get(_ENV_ITERS, "3")))


def probe_warmup() -> int:
    return max(0, int(os.environ.get(_ENV_WARMUP, "1")))


def cache_path() -> Optional[str]:
    """Resolved probe-cache path, or None when persistence is disabled
    (TDX_PLANNER_PROBE_CACHE set to the empty string)."""
    if _ENV_PATH in os.environ:
        p = os.environ[_ENV_PATH]
        return p or None
    base = os.environ.get("XDG_CACHE_HOME") or os.path.join(
        os.path.expanduser("~"), ".cache"
    )
    return os.path.join(
        base, "pytorch_distributed_example_tpu_torch", "probe_cache.json"
    )


class ProbeCache:
    """{topology_key: {"op:bucket": {alg: seconds}}} with atomic,
    merging persistence."""

    def __init__(self, path: Optional[str] = None):
        self.path = path if path is not None else cache_path()
        self._tables: Dict[str, Dict[str, Dict[str, float]]] = {}
        self._warned_stale = False
        self._loaded = False

    # -- disk --------------------------------------------------------------

    def load(self) -> "ProbeCache":
        self._loaded = True
        if not self.path or not os.path.exists(self.path):
            return self
        try:
            with open(self.path) as f:
                doc = json.load(f)
            if doc.get("version") == _VERSION:
                self._tables = dict(doc.get("topologies", {}))
        except (OSError, ValueError):
            logger.warning(
                "planner probe cache %s unreadable; reprobing", self.path
            )
            self._tables = {}
        return self

    def save(self) -> None:
        if not self.path:
            return
        try:
            os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
            # merge-on-write: keep other topologies' rows another process
            # persisted since our load
            on_disk: Dict = {}
            if os.path.exists(self.path):
                try:
                    with open(self.path) as f:
                        doc = json.load(f)
                    if doc.get("version") == _VERSION:
                        on_disk = doc.get("topologies", {})
                except (OSError, ValueError):
                    on_disk = {}
            for k, table in self._tables.items():
                merged = dict(on_disk.get(k, {}))
                merged.update(table)
                on_disk[k] = merged
            fd, tmp = tempfile.mkstemp(
                dir=os.path.dirname(self.path) or ".", suffix=".tmp"
            )
            with os.fdopen(fd, "w") as f:
                json.dump({"version": _VERSION, "topologies": on_disk}, f,
                          indent=1, sort_keys=True)
            os.replace(tmp, self.path)
        except OSError:
            logger.warning(
                "planner probe cache %s not writable; choices will be "
                "reprobed next run", self.path,
            )

    # -- lookups -----------------------------------------------------------

    def _check_stale(self, topo_key: str) -> None:
        if self._warned_stale or not self._tables:
            return
        if topo_key not in self._tables:
            self._warned_stale = True
            logger.warning(
                "planner probe cache %s holds topology key(s) %s but the "
                "live gang is %s — cached timings do not apply to this "
                "topology; probing fresh (the new key is persisted "
                "alongside)", self.path, sorted(self._tables), topo_key,
            )

    def lookup(self, topo_key: str, op: str, bucket: int,
               plane: str = "driver") -> Optional[Dict[str, float]]:
        """Timings are keyed by execution PLANE as well as (op, bucket):
        driver-plane timings say nothing about the TCP p2p plane's
        ring-vs-tree cost structure, so the two must never read (or
        clobber) each other's rows."""
        if not self._loaded:
            self.load()
        self._check_stale(topo_key)
        return self._tables.get(topo_key, {}).get(f"{op}:{plane}:{bucket}")

    def update(self, topo_key: str, op: str, bucket: int,
               timings: Dict[str, float], plane: str = "driver") -> None:
        if not self._loaded:
            self.load()
        self._tables.setdefault(topo_key, {})[f"{op}:{plane}:{bucket}"] = {
            k: round(float(v), 9) for k, v in timings.items()
        }
        self.save()


def probe_driver(mesh, axis: str, world: int, op: str,
                 candidates: Iterable[str], bucket: int,
                 reduce_kind: str = "sum", dtype=None) -> Dict[str, float]:
    """Time each candidate's body on the driver plane at the bucket's
    payload size: a rank-stacked payload of W rows on the mesh's device
    (float32 unless `dtype` says otherwise); returns {alg:
    seconds-per-call}. Fired through `plan.probe` per candidate so chaos
    plans can perturb or fail probing deterministically. The card is
    timed with CUDA events, the CPU with `perf_counter`."""
    import numpy as np
    import torch

    from .. import traceguard
    from . import driver

    if traceguard.under_tracing():
        # timing programs is host work — reached from a trace (a
        # torch.func transform or torch.compile) it would run once for
        # every rank, or be baked into the graph. The traced path must
        # prepare() BEFORE the step runs.
        raise traceguard.TraceGuardError(
            "plan.probe.probe_driver called under tracing: probing runs "
            "and times host programs; probe outside the trace "
            "(plan.traced.prepare) and let the trace read the agreed "
            "table"
        )

    dtype = dtype or torch.float32
    dev = torch.device(mesh.device) if mesh is not None else torch.device("cpu")
    itemsize = torch.empty((), dtype=dtype).element_size()
    # per-rank payload of the bucket's size, rounded to the chunk
    # granularity every candidate accepts
    n = max(bucket // itemsize, world * world)
    n -= n % (world * world)
    rng = np.random.default_rng(0)
    base = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(dev, dtype)
    if op == "reduce_scatter":
        x = base.repeat(world, 1).reshape(world, world, n // world)
    else:  # all_reduce / all_gather take the flat per-rank payload
        x = base.repeat(world, 1)
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    iters, warm = probe_iters(), probe_warmup()
    out: Dict[str, float] = {}
    for alg in candidates:
        faults.fire("plan.probe", op=op, algorithm=alg, bucket=bucket)
        prog = driver.compiled_body(op, alg, world, axis, mesh, reduce_kind)
        prog(x)
        sync()  # settle
        for _ in range(warm):
            prog(x)
        sync()
        if cuda:
            t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t0.record()
            for _ in range(iters):
                prog(x)
            t1.record()
            t1.synchronize()
            out[alg] = t0.elapsed_time(t1) / 1e3 / iters
        else:
            t0 = time.perf_counter()
            for _ in range(iters):
                prog(x)
            out[alg] = (time.perf_counter() - t0) / iters
    return out
