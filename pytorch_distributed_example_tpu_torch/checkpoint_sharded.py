"""Sharded (distributed) checkpoint over `torch.distributed.checkpoint`: the
port of the reference's `checkpoint_sharded.py`, whose engine is orbax.

DCP is torch's sharded-checkpoint engine: per-rank `.distcp` files and a
global `.metadata` index. The reference's facade keeps its c10d-shaped
names here:

  * `dcp_save(state, path)`: every process writes the shards it holds.
  * `dcp_load(template, path)`: restores INTO the template's layout,
    resharding on load when the saved layout differs.

The port's `DTensor` is its own class (its ranks' locals stacked on one
device, `dtensor.py`), so DCP sees plain tensors: each stored local of a
leaf (one a stack position; a Replicate axis stores one for all its
ranks) is its own DCP entry, and `layout.json` records the leaf's global
shape, dtype, mesh, placements and the offsets of each entry in the
global tensor. A `DistTensor` (rank-stacked rows, e.g. a ZeRO state's
shard rows) writes a row a rank, as Shard(0) of the rows' concatenation;
in multiproc mode a process holds and writes only its own rows. A plain
tensor is one entry, written once. Python scalars live in `layout.json`.

`dcp_load` reads leaf by leaf: for each leaf the entries that overlap the
template's locals are read to the host, the locals are assembled from
them and moved to the device, and the host copies are dropped, so the
whole tree is never held replicated. A batch of leaves shares one DCP
read up to `LOAD_BATCH_BYTES`.

Integrity: the CRC manifest of `checkpoint.py` caps every directory and
covers DCP's `.metadata` index too (the reference's manifest skips
dotfiles; orbax keeps none).
"""

from __future__ import annotations

import json
import math
import os
import shutil
import threading
import time
import warnings
from typing import Any, Dict, List, Mapping, Optional, Tuple

import torch

from .checkpoint import (
    CheckpointCorruptError,
    _py_flatten,
    verify_checkpoint,
    write_manifest,
)
from .dtensor import DTensor, Partial, Replicate, Shard, distribute_tensor, spec_to_placements, stack_shape
from .mesh import DeviceMesh
from .tensor import DistTensor

__all__ = [
    "dcp_save",
    "dcp_async_save",
    "dcp_load",
    "DCPCheckpointer",
    "resharded_template",
    "AsyncSaveHandle",
]

LAYOUT = "layout.json"
LOAD_BATCH_BYTES = 1 << 30  # host bytes of saved entries read per DCP call


# ---------------------------------------------------------------------------
# tree structure, JSON-able
# ---------------------------------------------------------------------------


def _skeleton(tree):
    """The tree's structure as JSON: leaves become ["leaf"]."""
    if tree is None:
        return ["none"]
    if isinstance(tree, dict):
        return ["dict", [[k, _skeleton(tree[k])] for k in sorted(tree)]]
    if isinstance(tree, (list, tuple)):
        return ["tuple" if isinstance(tree, tuple) else "list", [_skeleton(v) for v in tree]]
    return ["leaf"]


def _rebuild(skel, leaves):
    it = iter(leaves)

    def one(s):
        kind = s[0]
        if kind == "none":
            return None
        if kind == "dict":
            return {k: one(v) for k, v in s[1]}
        if kind in ("list", "tuple"):
            seq = [one(v) for v in s[1]]
            return tuple(seq) if kind == "tuple" else seq
        return next(it)

    return one(skel)


# ---------------------------------------------------------------------------
# leaves -> entries (save) and layouts
# ---------------------------------------------------------------------------


def _placement_text(p) -> str:
    if isinstance(p, Shard):
        return f"S{p.dim}"
    return "R"


def _stack_chunks(local_shape, mesh_shape, placements) -> List[Tuple[Tuple[int, ...], List[int]]]:
    """(stack index, global offsets) of every stored local of a DTensor,
    in row-major stack order."""
    sshape = tuple(1 if isinstance(p, Replicate) else n for p, n in zip(placements, mesh_shape))
    out = []
    for flat in range(math.prod(sshape)):
        idx, r = [], flat
        for n in reversed(sshape):
            idx.append(r % n)
            r //= n
        idx = tuple(reversed(idx))
        offsets = [0] * len(local_shape)
        for j, p in zip(idx, placements):
            if isinstance(p, Shard):
                offsets[p.dim] = j * local_shape[p.dim]
        out.append((idx, offsets))
    return out


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def _dtype_of(name: str) -> torch.dtype:
    return getattr(torch, name)


def _local_rows(t: DistTensor) -> List[int]:
    from . import distributed as dist

    return dist._local_rows(t.group)


def _leaf_entries(i: int, leaf) -> Tuple[Dict[str, Any], Dict[str, torch.Tensor]]:
    """(layout record, {DCP key: tensor this process writes}) of leaf i."""
    key = f"leaf_{i}"
    if isinstance(leaf, DTensor):
        if any(isinstance(p, Partial) for p in leaf.placements):
            leaf = distribute_tensor(leaf.full_tensor(), leaf.device_mesh, [
                Replicate() if isinstance(p, Partial) else p for p in leaf.placements])
        mesh = leaf.device_mesh
        local_shape = list(leaf.local_shape)
        chunks, entries = [], {}
        for j, (idx, off) in enumerate(_stack_chunks(local_shape, mesh.shape, leaf.placements)):
            chunks.append({"key": f"{key}/{j}", "offsets": off, "sizes": local_shape})
            entries[f"{key}/{j}"] = leaf._local[idx]
        rec = {"kind": "dtensor", "shape": list(leaf.shape), "dtype": _dtype_name(leaf.dtype),
               "mesh": {"shape": list(mesh.shape), "axes": list(mesh.axis_names)},
               "placements": [_placement_text(p) for p in leaf.placements], "chunks": chunks}
        return rec, entries
    if isinstance(leaf, DistTensor):
        rows = leaf.tensor
        W = leaf.group.size()
        row = list(rows.shape[1:]) or [1]
        local = _local_rows(leaf)
        chunks = [{"key": f"{key}/{r}", "offsets": [r * row[0]] + [0] * (len(row) - 1),
                   "sizes": row} for r in range(W)]
        entries = {f"{key}/{r}": rows[n].reshape(row) for n, r in enumerate(local)}
        rec = {"kind": "rows", "shape": [W * row[0]] + row[1:], "dtype": _dtype_name(rows.dtype),
               "row_shape": list(rows.shape[1:]), "world": W, "chunks": chunks}
        return rec, entries
    if isinstance(leaf, torch.Tensor):
        shape = list(leaf.shape)
        rec = {"kind": "tensor", "shape": shape, "dtype": _dtype_name(leaf.dtype),
               "chunks": [{"key": key, "offsets": [0] * len(shape), "sizes": shape}]}
        return rec, {key: leaf.detach()}
    if isinstance(leaf, (bool, int, float, str)):
        return {"kind": "py", "value": leaf, "type": type(leaf).__name__}, {}
    raise TypeError(f"dcp_save: unsupported leaf {type(leaf).__name__}")


def _process_index() -> Tuple[int, Any]:
    """(this process's index, the torch.distributed group a save spans or
    None in a single process)."""
    from . import distributed as dist

    if not dist.is_initialized() or dist._world.mode == "driver":
        return 0, None
    g = dist._get_default_group()
    return g.rank(), _ckpt_group(g)


_CKPT_GROUPS: Dict[int, Any] = {}


def _ckpt_group(g):
    """A gloo group over `g`'s processes for DCP's own exchanges, made once
    a group: the checkpoint's plan exchange and a background write never
    share the training collectives' channel."""
    import torch.distributed as tdist

    key = id(g)
    if key not in _CKPT_GROUPS:
        ranks = [tdist.get_global_rank(g.torch_group, r) for r in range(g.size())]
        _CKPT_GROUPS[key] = tdist.new_group(ranks=ranks, backend="gloo")
    return _CKPT_GROUPS[key]


def _barrier(pg) -> None:
    if pg is not None:
        import torch.distributed as tdist

        tdist.barrier(group=pg)


def _snapshot(state) -> Tuple[Dict[str, Any], Dict[str, torch.Tensor]]:
    """(layout document, this process's entries)."""
    records, entries = [], {}
    for i, (p, leaf) in enumerate(_py_flatten(state)):
        rec, ent = _leaf_entries(i, leaf)
        rec["path"] = p
        records.append(rec)
        entries.update(ent)
    return {"version": 1, "skeleton": _skeleton(state), "leaves": records}, entries


def _dcp(fn, pg, **kw):
    """A DCP call; in a single process, without the warning DCP gives
    when no process group is up (the intended case here)."""
    if pg is not None:
        return fn(process_group=pg, **kw)
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="torch.distributed is disabled")
        return fn(no_dist=True, **kw)


def _write(layout, entries, path: str, pg, index: int) -> str:
    import torch.distributed.checkpoint as dcp

    _dcp(dcp.save, pg, state_dict=entries, checkpoint_id=path)
    if index == 0:
        with open(os.path.join(path, LAYOUT), "w") as f:
            json.dump(layout, f)
            f.flush()
            os.fsync(f.fileno())
    _barrier(pg)
    if index == 0:
        write_manifest(path, dotfiles=True)
    _barrier(pg)
    return path


def _prepare_dir(path: str, force: bool, index: int, pg) -> None:
    if index == 0 and os.path.exists(path):
        if not force:
            raise FileExistsError(f"checkpoint {path} exists; pass force=True")
        shutil.rmtree(path)
    _barrier(pg)


def dcp_save(state: Any, path: str, *, force: bool = True) -> str:
    """Write a (possibly sharded) tree; each process writes only the shards
    it holds (its ranks' rows in multiproc mode). Returns the directory.

    Process 0 writes `layout.json` and caps the write with the recursive
    CRC manifest (`.metadata` included), so `dcp_load` detects on-disk
    corruption before DCP deserializes."""
    path = os.path.abspath(path)
    index, pg = _process_index()
    layout, entries = _snapshot(state)
    _prepare_dir(path, force, index, pg)
    return _write(layout, entries, path, pg, index)


class AsyncSaveHandle:
    """Future-shaped handle of `dcp_async_save` (torch's `async_save`
    returns a Future). A writer thread persists the host snapshot, so
    `done()` flips on its own and `result(timeout=...)` honors the Future
    contract (TimeoutError on expiry; the write keeps running)."""

    def __init__(self, target, path: str):
        self.path = path
        self._error: Optional[BaseException] = None
        self.finished_at: Optional[float] = None

        def run():
            try:
                target()
            except BaseException as e:  # surfaced by result()
                self._error = e
            finally:
                self.finished_at = time.perf_counter()

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def result(self, timeout: Optional[float] = None) -> str:
        """Block until the write is durable; returns the directory."""
        self._thread.join(timeout)
        if self._thread.is_alive():
            raise TimeoutError(f"checkpoint write to {self.path} still in flight after {timeout}s")
        if self._error is not None:
            raise self._error
        return self.path

    wait = result  # Future-protocol alias

    def done(self) -> bool:
        return not self._thread.is_alive()


def dcp_async_save(state: Any, path: str, *, force: bool = True) -> AsyncSaveHandle:
    """torch DCP's `async_save`: snapshot the state to the host, then
    persist in the background. Training resumes once the device-to-host
    copy is taken, not when the bytes reach the disk. Call `.result()`
    before relying on (or overwriting) the checkpoint."""
    path = os.path.abspath(path)
    index, pg = _process_index()
    layout, entries = _snapshot(state)
    host = {k: t.detach().to("cpu", copy=True) for k, t in entries.items()}
    _prepare_dir(path, force, index, pg)
    return AsyncSaveHandle(lambda: _write(layout, host, path, pg, index), path)


# ---------------------------------------------------------------------------
# templates and load
# ---------------------------------------------------------------------------


def resharded_template(tree: Any, mesh: DeviceMesh, specs: Any = None, rules: Any = None) -> Any:
    """Memory-light restore template for another layout than the
    checkpoint's: `DTensor`s whose locals live on the meta device, laid out
    over `mesh`, so `dcp_load` reshards ON LOAD: a world-2 FSDP/ZeRO
    checkpoint restores straight into a world-1 (or world-4) layout,
    reading only the entries each local needs, and no replicated tree is
    made.

    `tree` supplies shapes and dtypes (tensors, DTensors); the layout
    comes from `specs` (a tree of specs, as `parallel.sharding.spec_for`
    gives them) or `rules` (a `parallel.sharding` rule table, matched
    against each leaf's dotted name); with neither every leaf replicates
    over `mesh`."""
    from .parallel import sharding as shd

    def one(leaf, spec, name):
        shape = tuple(leaf.shape)
        if spec is None and rules is not None:
            spec = shd.spec_for(name, shape, rules, mesh)
        placements = spec_to_placements(spec, mesh)
        local = list(shape)
        for ax, p, n in zip(mesh.axis_names, placements, mesh.shape):
            if isinstance(p, Shard):
                if local[p.dim] % n:
                    raise ValueError(f"{name}: dim {p.dim} of {shape} does not split over "
                                     f"{ax!r} of {n}")
                local[p.dim] //= n
        stack = stack_shape(mesh, placements)
        return DTensor(torch.empty(stack + tuple(local), dtype=leaf.dtype, device="meta"),
                       mesh, placements)

    def walk(t, s, prefix):
        if isinstance(t, Mapping):
            return {k: walk(v, None if s is None else s[k], prefix + (str(k),))
                    for k, v in t.items()}
        return one(t, s, ".".join(prefix))

    return walk(tree, specs, ())


def _target_regions(tleaf, rec) -> List[Tuple[Any, List[int], List[int]]]:
    """(slot, offsets, sizes) of every local the template leaf wants."""
    if isinstance(tleaf, DTensor):
        local = list(tleaf.local_shape)
        return [(idx, off, local)
                for idx, off in _stack_chunks(local, tleaf.device_mesh.shape, tleaf.placements)]
    if isinstance(tleaf, DistTensor):
        row = list(tleaf.tensor.shape[1:]) or [1]
        return [(n, [r * row[0]] + [0] * (len(row) - 1), row)
                for n, r in enumerate(_local_rows(tleaf))]
    return [(None, [0] * len(rec["shape"]), list(rec["shape"]))]


def _overlap(off_a, size_a, off_b, size_b):
    """Per-dim [lo, hi) of two boxes' intersection, or None."""
    lo = [max(a, b) for a, b in zip(off_a, off_b)]
    hi = [min(a + x, b + y) for a, x, b, y in zip(off_a, size_a, off_b, size_b)]
    if any(h <= l for l, h in zip(lo, hi)):
        return None
    return lo, hi


def _assemble(region_off, region_size, chunks, data, dtype) -> torch.Tensor:
    out = torch.empty(region_size, dtype=dtype)
    filled = 0
    for c in chunks:
        ov = _overlap(region_off, region_size, c["offsets"], c["sizes"])
        if ov is None:
            continue
        lo, hi = ov
        dst = tuple(slice(l - o, h - o) for l, h, o in zip(lo, hi, region_off))
        src = tuple(slice(l - o, h - o) for l, h, o in zip(lo, hi, c["offsets"]))
        out[dst] = data[c["key"]][src]
        filled += math.prod(h - l for l, h in zip(lo, hi))
    if filled != math.prod(region_size):
        raise ValueError(f"saved shards cover {filled} of the {math.prod(region_size)} "
                         "elements a local needs")
    return out


def _materialize(tleaf, locals_):
    if isinstance(tleaf, DTensor):
        stack = torch.stack([t for _, t in locals_]).reshape(
            stack_shape(tleaf.device_mesh, tleaf.placements) + tuple(tleaf.local_shape))
        dev = tleaf.device_mesh.device if tleaf._local.is_meta else tleaf._local.device
        return DTensor(stack.to(dev), tleaf.device_mesh, tleaf.placements)
    if isinstance(tleaf, DistTensor):
        rows = torch.stack([t.reshape(tleaf.tensor.shape[1:]) for _, t in locals_])
        return DistTensor.wrap(rows.to(tleaf.tensor.device), tleaf.group)
    t = locals_[0][1].reshape(tleaf.shape)
    return t if tleaf.is_meta else t.to(tleaf.device)  # a meta template: the host's copy


def _check_leaf(tleaf, rec) -> None:
    if rec["kind"] == "py":
        return
    want = tuple(rec["shape"])
    if isinstance(tleaf, DistTensor):
        got = (tleaf.group.size() * (tuple(tleaf.tensor.shape[1:]) or (1,))[0],) + tuple(
            tleaf.tensor.shape[2:])
    else:
        got = tuple(tleaf.shape)
    if got != want:
        raise ValueError(f"{rec['path']}: checkpoint shape {want} vs template {got}")
    if tleaf.dtype != _dtype_of(rec["dtype"]):
        raise ValueError(f"{rec['path']}: checkpoint dtype {rec['dtype']} vs template "
                         f"{tleaf.dtype}")


def dcp_load(template: Any, path: str, stats: Optional[Dict[str, float]] = None) -> Any:
    """Restore into `template`'s structure AND layout.

    `template` supplies the target tree: `DTensor`s (their mesh and
    placements are the restore layout; resharding happens here if they
    differ from save time; meta locals, as `resharded_template` makes, are
    filled on the mesh's device), `DistTensor`s (their rows), tensors (the
    global value, on the tensor's device; on the CPU for a meta tensor),
    or Python scalars. With `template=None` the saved tree comes back with
    global tensors on the CPU. A `stats` dict gets the load's seconds
    ("seconds", of them the CRC check's "verify_s"), the bytes read
    ("read_bytes") and the most saved bytes held on the host at once
    ("peak_host_bytes")."""
    import torch.distributed.checkpoint as dcp

    path = os.path.abspath(path)
    # every process verifies (shared storage: the same verdict everywhere),
    # so all raise together on corruption
    t0 = time.perf_counter()
    ok, detail = verify_checkpoint(path, require=(".metadata", LAYOUT))
    if not ok:
        raise CheckpointCorruptError(f"sharded checkpoint {path}: {detail}")
    verify_s = time.perf_counter() - t0
    with open(os.path.join(path, LAYOUT)) as f:
        layout = json.load(f)
    records = layout["leaves"]
    if template is None:
        t_leaves = [None if r["kind"] == "py" else torch.empty(r["shape"], dtype=_dtype_of(
            r["dtype"]), device="meta") for r in records]
        skel = layout["skeleton"]
        t_paths = [r["path"] for r in records]
    else:
        flat = _py_flatten(template)
        t_paths, t_leaves = [p for p, _ in flat], [v for _, v in flat]
        skel = None
    if t_paths != [r["path"] for r in records]:
        missing = set(r["path"] for r in records) - set(t_paths)
        extra = set(t_paths) - set(r["path"] for r in records)
        raise ValueError(f"checkpoint/template structure mismatch; missing={sorted(missing)[:3]} "
                         f"extra={sorted(extra)[:3]}")

    out: List[Any] = [None] * len(records)
    read_bytes, peak_host = 0, 0
    batch: List[int] = []
    batch_bytes = 0

    def flush():
        nonlocal read_bytes, peak_host
        if not batch:
            return
        want = {}
        needed = {}
        for i in batch:
            rec, tleaf = records[i], t_leaves[i]
            regions = _target_regions(tleaf, rec)
            needed[i] = regions
            for c in rec["chunks"]:
                if any(_overlap(off, size, c["offsets"], c["sizes"]) for _, off, size in regions):
                    want[c["key"]] = torch.empty(c["sizes"], dtype=_dtype_of(rec["dtype"]))
        _dcp(dcp.load, None, state_dict=want, checkpoint_id=path)
        held = sum(t.numel() * t.element_size() for t in want.values())
        read_bytes += held
        for i in batch:
            rec, tleaf = records[i], t_leaves[i]
            locals_ = [(slot, _assemble(off, size, rec["chunks"], want, _dtype_of(rec["dtype"])))
                       for slot, off, size in needed[i]]
            peak_host = max(peak_host, held + sum(t.numel() * t.element_size()
                                                  for _, t in locals_))
            out[i] = _materialize(tleaf, locals_)
        want.clear()
        batch.clear()

    for i, (rec, tleaf) in enumerate(zip(records, t_leaves)):
        if rec["kind"] == "py":
            out[i] = rec["value"] if tleaf is None else type(tleaf)(rec["value"])
            continue
        if template is not None:
            _check_leaf(tleaf, rec)
        nbytes = math.prod(rec["shape"]) * _dtype_of(rec["dtype"]).itemsize
        if batch and batch_bytes + nbytes > LOAD_BATCH_BYTES:
            flush()
            batch_bytes = 0
        batch.append(i)
        batch_bytes += nbytes
    flush()
    if stats is not None:
        stats.update(verify_s=verify_s, seconds=time.perf_counter() - t0,
                     read_bytes=read_bytes, peak_host_bytes=peak_host)
    if skel is not None:
        return _rebuild(skel, out)
    from .checkpoint import _py_unflatten

    return _py_unflatten(template, out)


# ---------------------------------------------------------------------------
# step-numbered manager
# ---------------------------------------------------------------------------


class DCPCheckpointer:
    """Step-numbered checkpoint manager, the `CheckpointManager` shape
    (keep-last-k, latest-step query) torch users reach for around DCP."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)
        self._pending: List[Tuple[int, AsyncSaveHandle]] = []

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, str(step))

    def save(self, step: int, state: Any, wait: bool = True) -> bool:
        """`wait=False` returns after the device-to-host snapshot and lets
        the write land in the background (join with `wait_until_finished`
        or the next save). Steps beyond the newest `max_to_keep` go once a
        write has landed."""
        if wait:
            dcp_save(state, self._step_dir(step))
            self._prune()
        else:
            self._pending.append((step, dcp_async_save(state, self._step_dir(step))))
        return True

    def wait_until_finished(self):
        pending, self._pending = self._pending, []
        for _, handle in pending:
            handle.result()
        if pending:
            self._prune()

    def _prune(self) -> None:
        index, _ = _process_index()
        if index != 0 or not self.max_to_keep:
            return
        for step in self.all_steps()[:-self.max_to_keep]:
            shutil.rmtree(self._step_dir(step), ignore_errors=True)

    def _quarantine_step(self, step: int) -> Optional[str]:
        """Move a corrupt step OUT of the manager directory (process 0
        only; peers verifying mid-rename see a missing dir, the same
        not-ok verdict)."""
        index, _ = _process_index()
        if index != 0:
            return None
        src = self._step_dir(step)
        base = f"{self.directory}.quarantine.step{step}"
        for n in range(1000):
            dst = base if n == 0 else f"{base}.{n}"
            if not os.path.exists(dst):
                try:
                    os.rename(src, dst)
                    return dst
                except OSError:
                    return None
        return None

    def restore(self, step: Optional[int] = None, template: Any = None) -> Any:
        """Restore `step` (default: the latest). Each candidate step is
        CRC-verified first; a corrupt one is quarantined and, when the
        caller asked for the latest, the next-newest step is tried, so a
        torn write costs one checkpoint interval, not the job."""
        fall_back = step is None
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(f"no checkpoints under {self.directory}")
        failures = []
        while True:
            ok, detail = verify_checkpoint(self._step_dir(step), require=(".metadata", LAYOUT))
            if ok:
                break
            failures.append((step, detail))
            q = None if "vanished" in detail else self._quarantine_step(step)
            warnings.warn(f"corrupt checkpoint step {step}: {detail}"
                          + (f"; quarantined to {q}" if q else ""), RuntimeWarning, stacklevel=2)
            earlier = [s for s in self.all_steps() if s < failures[-1][0]]
            if not fall_back or not earlier:
                raise CheckpointCorruptError(
                    "no loadable checkpoint: " + "; ".join(f"step {s}: {d}" for s, d in failures))
            step = max(earlier)
        return dcp_load(template, self._step_dir(step))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def all_steps(self) -> List[int]:
        """The steps whose writes have landed."""
        out = []
        for name in os.listdir(self.directory):
            if name.isdigit() and os.path.exists(os.path.join(self.directory, name, LAYOUT)):
                out.append(int(name))
        return sorted(out)

    def close(self):
        self.wait_until_finished()


# torch.distributed.checkpoint-shaped aliases
save = dcp_save
load = dcp_load
