"""Geometry pre-warm — pay a resize's first-call costs BEFORE the resize.

The port of the reference's `serve/prewarm.py`. After a process-level
resize the new generation's engines pay their programs' first calls:
the reference compiles them, an eager engine pays the CUDA context's
lazy module loads, cuBLAS handle and workspace set-up, the caching
allocator's first segments and the decode path's first Python pass. The
autoscaler's reachable set is small by construction (hysteresis bands
and the max-step clamp bound the worlds it can request to
``[min_replicas, max_replicas]``), and the engine's bucketed shapes
bound the program calls per world, so every call a resize could need is
enumerable AHEAD of time.

What the port keeps in place of the reference's serialized executables.
The reference lowers and compiles the paged quadruple
(`serve/decode.py`'s `paged_programs`) per prefill width and serializes
the executables; its engine's ``precompiled=`` swaps them in behind a
shape-guarded dispatch. An eager engine has no executable to keep, so
the manifest records WHAT to warm: each entry names one (program,
shape), under the reference's file name (``prewarm-manifest.json``),
key format ``{name}:{shape}:tp{tp}`` and merging atomic write.
`load_precompiled` returns that table for one tp degree, and
``ServeEngine(precompiled=table)`` runs each listed call once at
construction, so the first token after a worker registers pays no
first-call cost. Dispatch stays the engine's own eager programs.

The warm pass EXECUTES (the reference's ``.lower()`` never does), so it
must leave the live engine as it found it: its prefill and decode
writes go through block-table rows that hold only the pool's sink block
(`serve/cache.py`), whose bytes are saved before and written back
after; its lanes are scratch tensors; the queue, the block tables, the
allocator and the metrics are never touched.

`enable_compile_cache` points the kernels' build cache
(`ops/_build.py`'s ``BUILD_DIR``) at a directory that every worker
incarnation shares, so a kernel built by one generation is a load for
the next.

Data-parallel width does NOT multiply the program set: every DP replica
runs the SAME single-card programs, so one warmed entry serves all
worlds in the autoscaler's band — `reachable_geometries` returns the
(world, tp, bucket) tuples for planning and reporting.
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .cache import _blocks, _leaves

__all__ = [
    "GeometrySpec",
    "enable_compile_cache",
    "reachable_geometries",
    "prewarm_engine_programs",
    "load_precompiled",
    "warm_engine",
]

_MANIFEST = "prewarm-manifest.json"
# the format of one manifest entry: a manifest another build wrote (the
# reference's executable file names) is foreign and loads as {}
_FORMAT = "torch-eager-warm/1"


def _mesh_tp(mesh) -> int:
    """The extent of a mesh's ``tp`` axis; 1 without a mesh or axis."""
    if mesh is None or "tp" not in getattr(mesh, "axis_names", ()):
        return 1
    return int(mesh.axis_size("tp"))


def _engine_tp(engine) -> int:
    """The TP degree an engine's programs run under. Keys the per-degree
    namespace inside a shared pre-warm dir: a disaggregated deployment
    warms one dir for BOTH pools' degrees and each engine loads only its
    own shapes."""
    return _mesh_tp(getattr(engine, "mesh", None))


@dataclass(frozen=True, order=True)
class GeometrySpec:
    """One geometry the autoscaler can land the gang on: `world` DP
    replicas, each a `tp`-way engine serving prefill bucket `bucket`."""

    world: int
    tp: int
    bucket: int


def enable_compile_cache(cache_dir: str) -> str:
    """Point the kernels' build cache at `cache_dir`, shared across
    worker incarnations: a kernel library one process built (a pre-warm
    pass, a previous generation, a sibling rank) is a load for the next.
    Returns the directory."""
    from ..ops import _build

    _build.BUILD_DIR = Path(cache_dir)
    return cache_dir


def reachable_geometries(
    policy,
    current_world: int,
    buckets: List[int],
    tp: int = 1,
    horizon: Optional[int] = None,
) -> List[GeometrySpec]:
    """Enumerate every (world, tp, bucket) the autoscaler can reach.

    `policy` is an `AutoscalePolicy` (min/max_replicas + max_step);
    `horizon` bounds how many DECISIONS ahead to plan — each decision
    moves at most `max_step` replicas, so ``horizon=1`` is the next
    tick's worlds only. None plans the whole hysteresis band."""
    lo = int(getattr(policy, "min_replicas", 1))
    hi = int(getattr(policy, "max_replicas", current_world))
    if horizon is not None:
        step = int(getattr(policy, "max_step", 1))
        lo = max(lo, int(current_world) - horizon * step)
        hi = min(hi, int(current_world) + horizon * step)
    return [
        GeometrySpec(world=w, tp=int(tp), bucket=int(b))
        for w in range(lo, hi + 1)
        for b in sorted(set(int(b) for b in buckets))
    ]


def _chunk_widths(engine, buckets: Optional[List[int]] = None) -> List[int]:
    """The prefill program widths the engine dispatches: chunked prefill
    runs at most the budget (buckets below it, and the budget itself),
    unchunked one width per bucket."""
    widths = [int(b) for b in (buckets if buckets is not None else engine.buckets)]
    budget = engine.prefill_chunk_tokens
    if budget is not None:
        widths = [w for w in widths if w < budget] + [int(budget)]
    return sorted(set(w for w in widths if 1 <= w <= engine.cfg.max_seq_len))


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def warm_engine(engine, entries) -> Dict[Tuple[str, int], float]:
    """Run each (program, shape) of `entries` that this engine dispatches
    once, leaving the live engine unchanged. Prefill widths outside the
    engine's dispatch set and slot shapes other than its own are skipped,
    as the reference's guarded dispatch falls back for them. Returns
    {(program, shape): seconds}."""
    from ..models.generate import model_device

    want = set((str(n), int(s)) for n, s in entries)
    S, nb = engine.cache.block_tables.shape
    widths = [C for C in _chunk_widths(engine, buckets=[s for n, s in want])
              if ("prefill_chunk", C) in want or ("first_token", C) in want]
    dev = model_device(engine.model)
    sink = engine.cache.invalid_block
    sink_rows = np.full((1, nb), sink, np.int32)
    sink_table = np.full((S, nb), sink, np.int32)
    timings: Dict[Tuple[str, int], float] = {}
    # the sink's bytes are garbage by design (dropped writes land there),
    # but the warm pass promises the pool back bit for bit
    saved = [(blk, blk[sink].clone()) for blk in map(_blocks, _leaves(engine.cache.tree))]
    lanes = (torch.zeros_like(engine._dev_lengths), torch.zeros_like(engine._dev_tokens),
             torch.zeros_like(engine._dev_rngs))
    first = key = None
    try:
        for C in widths:
            t0 = time.perf_counter()
            _, logits = engine._prefill_chunk(engine.cache.tree, np.zeros((1, C), np.int32),
                                              sink_rows, 0)
            _sync(dev)
            timings[("prefill_chunk", C)] = time.perf_counter() - t0
            t0 = time.perf_counter()
            first, key = engine._first_token(logits, C - 1, 0)
            _sync(dev)
            timings[("first_token", C)] = time.perf_counter() - t0
        if first is not None and ("attach", S) in want:
            t0 = time.perf_counter()
            lanes = engine._attach(*lanes, 0, 1, first, key)
            _sync(dev)
            timings[("attach", S)] = time.perf_counter() - t0
        if ("step", S) in want:
            t0 = time.perf_counter()
            engine._step(engine.cache.tree, *lanes, sink_table)
            _sync(dev)
            timings[("step", S)] = time.perf_counter() - t0
    finally:
        for blk, rows in saved:
            blk[sink].copy_(rows)
        _sync(dev)
    return {k: v for k, v in timings.items() if k in want}


def prewarm_engine_programs(
    engine,
    cache_dir: Optional[str] = None,
    buckets: Optional[List[int]] = None,
    save_dir: Optional[str] = None,
) -> Dict[Tuple[str, int], float]:
    """Warm the engine's paged quadruple for every prefill width it
    dispatches (the buckets, or the chunk budget) and its slot shape,
    leaving the live engine unchanged (`warm_engine`). With `cache_dir`
    the kernels' build cache moves there first; with `save_dir` the
    warmed (program, shape) set is merged into that directory's manifest
    under this engine's tp degree, for `load_precompiled`. Returns
    {(program, shape): seconds} — the runbook's first-call breakdown."""
    if cache_dir is not None:
        enable_compile_cache(cache_dir)
    S = engine.cache.block_tables.shape[0]
    entries = [(name, C) for C in _chunk_widths(engine, buckets)
               for name in ("prefill_chunk", "first_token")]
    entries += [("attach", S), ("step", S)]
    timings = warm_engine(engine, entries)
    if save_dir is not None:
        _save_manifest(timings, save_dir, tp=_engine_tp(engine))
    return timings


def _save_manifest(timings: Dict, save_dir: str, tp: int = 1) -> None:
    """Merge one warm pass's (program, shape) entries into `save_dir`'s
    manifest, namespaced by TP degree: one dir accumulates entries for
    MULTIPLE TP degrees (a disagg deployment warms prefill-TP and
    decode-TP passes into the same dir), each pass updating only its own
    ``{name}:{shape}:tp{tp}`` keys. The write stays atomic (tmp +
    replace), so a reader never sees a torn manifest — at worst it sees
    the pre-merge one and warms nothing for the new degree."""
    os.makedirs(save_dir, exist_ok=True)
    path = os.path.join(save_dir, _MANIFEST)
    try:
        with open(path) as f:
            manifest = json.load(f)
        if not isinstance(manifest, dict):
            manifest = {}
    except (OSError, ValueError):
        manifest = {}
    for (name, shape), seconds in timings.items():
        manifest[f"{name}:{int(shape)}:tp{int(tp)}"] = {
            "format": _FORMAT, "seconds": float(seconds)}
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(manifest, f)
    os.replace(tmp, path)


def _parse_manifest_key(key: str) -> Optional[Tuple[str, int, int]]:
    """``name:shape[:tpN]`` -> (name, shape, tp); legacy two-part keys
    (pre-disagg manifests) are tp=1. None for anything malformed."""
    parts = key.split(":")
    try:
        if len(parts) == 2:
            return parts[0], int(parts[1]), 1
        if len(parts) == 3 and parts[2].startswith("tp"):
            return parts[0], int(parts[1]), int(parts[2][2:])
    except ValueError:
        return None
    return None


def load_precompiled(
    save_dir: str, tp: Optional[int] = None, mesh=None
) -> Dict[Tuple[str, int], Dict]:
    """The pre-warm table FOR ONE TP DEGREE — selected explicitly
    (``tp=``) or from the engine's mesh (``mesh=``; its ``tp`` axis
    extent, 1 when absent or None): {(program, shape): entry}. Returns
    {} when the directory has no (complete) manifest, and drops entries
    of another format — a worker with a stale or foreign pre-warm dir
    warms nothing, it never refuses to start."""
    if tp is None:
        tp = _mesh_tp(mesh)
    try:
        with open(os.path.join(save_dir, _MANIFEST)) as f:
            manifest = json.load(f)
    except (OSError, ValueError):
        return {}
    if not isinstance(manifest, dict):
        return {}
    out: Dict[Tuple[str, int], Dict] = {}
    for key, entry in manifest.items():
        parsed = _parse_manifest_key(key)
        if parsed is None or parsed[2] != int(tp):
            continue
        if not isinstance(entry, dict) or entry.get("format") != _FORMAT:
            continue
        out[(parsed[0], parsed[1])] = entry
    return out
