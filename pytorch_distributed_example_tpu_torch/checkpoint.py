"""Checkpoint / resume with integrity guarantees: the port of the reference's
`checkpoint.py`.

DDP replication makes checkpointing rank-0-only: `save_checkpoint` is a
host-side dump of the replicated tree. A sharded tree goes through
`checkpoint_sharded.py` (torch.distributed.checkpoint) instead.

Format, the reference's: a directory with `meta.json` (step, leaf paths,
dtypes, shapes), `arrays.npz` (the leaves as `leaf_{i}`) and
`manifest.json` (CRC32 + size of each payload file). A tree is nested
dicts, lists, tuples and namedtuples of tensors, numpy arrays and Python
scalars; None is an empty subtree. The leaf paths are the reference's
(jax's flattener) byte for byte, so either package reads the other's
checkpoints. A `torch.optim` `state_dict()` round-trips: its integer keys
flatten as `[0]`, and its Python leaves (floats, bools, the ints of
`params`) come back as the template's Python types.

Leaves are tensors. A save brings each to the host (`.detach().cpu()`);
bfloat16, which numpy lacks, travels as its raw 16-bit words (uint16)
and is named "bfloat16" in `meta["dtypes"]`, as the reference names it.
A load gives each leaf back as a tensor on its template leaf's device, in
the recorded dtype, byte for byte.

Integrity contract:

  * **Atomic writes**: a save lands in `<path>.tmp.<pid>`, is fsynced, and
    is renamed into place last; a mid-write kill leaves the old checkpoint
    or an ignorable tmp dir, never a half-written loadable one.
  * **CRC manifest**: `manifest.json` records crc32 + size of every payload
    file; `load_checkpoint` verifies before deserializing anything.
  * **Last-good fallback**: the swap keeps the previously live checkpoint
    at `<path>.prev`; a live one that fails verification is quarantined to
    `<path>.quarantine.<n>` and the load falls back to the last-good copy
    (a warning, not a crash). No valid candidate raises
    `CheckpointCorruptError`.

Fault points: `checkpoint.write` (before any bytes) and
`checkpoint.finalize` (after the tmp dir is complete, before the rename):
`crash` at either models a mid-write kill, and `corrupt` at finalize flips
payload bytes after the manifest is sealed.
"""

from __future__ import annotations

import json
import os
import shutil
import struct
import time
import warnings
import zipfile
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from . import faults
from .numerics import numerics_contract
from .types import DistError

MANIFEST = "manifest.json"
_PAYLOAD_FILES = ("meta.json", "arrays.npz")
# dtypes numpy cannot hold, carried as raw words of the same width
_RAW_WORDS = {torch.bfloat16: (torch.int16, np.uint16, "bfloat16")}
_FROM_NAME = {"bfloat16": torch.bfloat16}


class CheckpointCorruptError(DistError):
    """No loadable checkpoint: the live copy failed CRC verification and
    no last-good fallback exists (or it is corrupt too)."""


# ---------------------------------------------------------------------------
# Tree flattening, with the jax flattener's path strings
# ---------------------------------------------------------------------------


def _py_flatten(tree, prefix: Tuple[str, ...] = ()) -> List[Tuple[str, Any]]:
    # path strings match the jax flattener byte for byte: str(DictKey(k))
    # is f"[{k!r}]" (string 'w' -> "['w']", int 1 -> "[1]"),
    # str(SequenceKey(i)) is "[i]", str(GetAttrKey(f)) is ".f"
    # (namedtuples), entries joined by "/"; None is an empty subtree
    if tree is None:
        return []
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):  # jax sorts dict keys the same way
            out.extend(_py_flatten(tree[k], prefix + (f"[{k!r}]",)))
        return out
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):  # namedtuple
        out = []
        for f, v in zip(tree._fields, tree):
            out.extend(_py_flatten(v, prefix + (f".{f}",)))
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out.extend(_py_flatten(v, prefix + (f"[{i}]",)))
        return out
    return [("/".join(prefix), tree)]


def _py_unflatten(template, leaves: List[Any]):
    it = iter(leaves)

    def rebuild(t):
        if t is None:
            return None  # empty subtree: consumes no leaf
        if isinstance(t, dict):
            # leaves in sorted key order, keys in the template's order
            # (torch's pytree and state dicts go by insertion order)
            built = {k: rebuild(t[k]) for k in sorted(t)}
            return {k: built[k] for k in t}
        if isinstance(t, tuple) and hasattr(t, "_fields"):
            return type(t)(*(rebuild(v) for v in t))  # namedtuple ctor
        if isinstance(t, (list, tuple)):
            return type(t)(rebuild(v) for v in t)
        return next(it)

    return rebuild(template)


def _flatten_with_paths(tree):
    flat = _py_flatten(tree)
    return [p for p, _ in flat], [v for _, v in flat]


def _to_host(leaf) -> Tuple[np.ndarray, str]:
    """(host array, recorded dtype name) of one leaf."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype in _RAW_WORDS:
            words, np_words, name = _RAW_WORDS[t.dtype]
            return t.view(words).numpy().view(np_words), name
        a = t.numpy()
        return a, str(a.dtype)
    a = np.asarray(leaf)
    return a, str(a.dtype)


def _from_host(a: np.ndarray, dtype_name: str, template):
    """A loaded array as the template leaf's kind: a tensor (on the
    template's device, in the recorded dtype), or the template's Python
    type for a Python leaf."""
    if isinstance(template, (bool, int, float, complex, str)):
        return type(template)(a.item())
    a = a if a.flags.c_contiguous else a.copy()  # 0-d arrays keep their shape
    if dtype_name in _FROM_NAME:
        # the reference writes bfloat16 as 2-byte voids, the port as uint16
        t = torch.from_numpy(a.view(np.int16)).view(_FROM_NAME[dtype_name])
    else:
        t = torch.from_numpy(a)
    device = template.device if isinstance(template, torch.Tensor) else "cpu"
    return t.to(device)


def _read_npz(path: str, names: List[str]) -> List[np.ndarray]:
    """The named arrays of an `.npz`. A stored (uncompressed) member is
    read straight from its offset into its array, without zipfile's CRC
    pass: the manifest's CRC has already covered every byte of the file.
    A compressed member goes through `np.load`."""
    out = []
    with zipfile.ZipFile(path) as zf, open(path, "rb") as f:
        for name in names:
            info = zf.getinfo(f"{name}.npy")
            fmt = np.lib.format
            version = None
            if info.compress_type == zipfile.ZIP_STORED:
                f.seek(info.header_offset)
                header = f.read(30)  # the local file header: its name and extra lengths
                name_len, extra_len = struct.unpack("<HH", header[26:30])
                f.seek(info.header_offset + 30 + name_len + extra_len)
                version = fmt.read_magic(f)
            if version not in ((1, 0), (2, 0)):
                with zf.open(info) as member:
                    out.append(fmt.read_array(member))
                continue
            read_header = fmt.read_array_header_1_0 if version == (1, 0) else \
                fmt.read_array_header_2_0
            shape, fortran, dtype = read_header(f)
            a = np.empty(shape, dtype=dtype, order="F" if fortran else "C")
            if a.nbytes and f.readinto(memoryview(a.reshape(-1, order="A")).cast("B")) != a.nbytes:
                raise ValueError(f"{path}: {name} is truncated")
            out.append(a)
    return out


# ---------------------------------------------------------------------------
# Integrity primitives
# ---------------------------------------------------------------------------


def _crc32_file(path: str) -> Tuple[int, int]:
    crc = 0
    size = 0
    with open(path, "rb") as f:
        while True:
            chunk = f.read(1 << 20)
            if not chunk:
                break
            crc = zlib.crc32(chunk, crc)
            size += len(chunk)
    return crc & 0xFFFFFFFF, size


def _fsync_dir(path: str) -> None:
    try:
        fd = os.open(path, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)
    except OSError:
        pass  # some filesystems refuse directory fsync


def write_manifest(path: str, extra: Optional[Dict[str, Any]] = None,
                   dotfiles: bool = False) -> str:
    """Record crc32 + size of every payload file under `path` (recursive)
    in `path`/manifest.json. Dotfiles are skipped, as the reference skips
    them, unless `dotfiles`: a torch.distributed.checkpoint directory
    keeps its index in `.metadata`, and `checkpoint_sharded` covers it."""
    files = {}
    for root, dirs, names in os.walk(path):
        dirs[:] = sorted(d for d in dirs if dotfiles or not d.startswith("."))
        for name in sorted(names):
            rel = os.path.relpath(os.path.join(root, name), path)
            if rel == MANIFEST or (name.startswith(".") and not dotfiles):
                continue
            crc, size = _crc32_file(os.path.join(root, name))
            files[rel] = {"crc32": crc, "size": size}
    doc = {"version": 1, "files": files}
    if extra:
        doc.update(extra)
    mpath = os.path.join(path, MANIFEST)
    with open(mpath, "w") as f:
        json.dump(doc, f)
        f.flush()
        os.fsync(f.fileno())
    return mpath


def verify_checkpoint(path: str, require: Tuple[str, ...] = ()) -> Tuple[bool, str]:
    """(ok, detail). A directory with no manifest is reported ok with
    detail "no manifest" (pre-integrity checkpoints stay loadable), but any
    manifest present must verify exactly. `require` names files that must
    exist even without a manifest (rejects a write that died before its
    manifest landed)."""
    if not os.path.isdir(path):
        return False, "not a directory"
    mpath = os.path.join(path, MANIFEST)
    if not os.path.exists(mpath):
        if not all(os.path.exists(os.path.join(path, n)) for n in require):
            return False, "incomplete checkpoint (missing payload files)"
        return True, "no manifest"
    try:
        with open(mpath) as f:
            doc = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        return False, f"unreadable manifest: {e}"
    for name, rec in (doc.get("files") or {}).items():
        full = os.path.join(path, name)
        if not os.path.exists(full):
            return False, f"missing file {name}"
        try:
            crc, size = _crc32_file(full)
        except OSError as e:
            # another process quarantined/renamed this checkpoint while
            # we were reading it: report unverifiable, never crash
            return False, f"{name}: vanished during verify ({e})"
        if size != rec.get("size"):
            return False, f"{name}: size {size} != manifest {rec.get('size')}"
        if crc != rec.get("crc32"):
            return (False, f"{name}: crc32 {crc:#010x} != manifest "
                           f"{int(rec.get('crc32', 0)):#010x}")
    return True, "ok"


def _quarantine(path: str) -> Optional[str]:
    """Move a corrupt checkpoint aside for forensics (never delete it)."""
    for n in range(1000):
        dst = f"{path}.quarantine.{n}"
        if not os.path.exists(dst):
            try:
                os.rename(path, dst)
                return dst
            except OSError:
                return None
    return None


def last_good_path(path: str) -> str:
    """Where the atomic swap parks the previously live checkpoint."""
    return path + ".prev"


# ---------------------------------------------------------------------------
# Save / load
# ---------------------------------------------------------------------------

@numerics_contract(
    "bitwise",
    note="save/load round-trips the live param tree bit-exactly: leaf "
    "dtypes are recorded in the manifest and restored on load, never "
    "silently re-cast",
)
def save_checkpoint(
    path: str,
    params: Any,
    opt_state: Any = None,
    step: int = 0,
    extra: Optional[Dict[str, Any]] = None,
    timings: Optional[Dict[str, float]] = None,
) -> str:
    """Rank-0-style host save of (params, opt_state) to a directory.

    Atomic: bytes land in `<path>.tmp.<pid>` (CRC manifest last, fsynced),
    then one rename swaps it live; the previously live checkpoint moves to
    `<path>.prev` and serves as the load-time fallback. A `timings` dict
    gets the seconds of the device-to-host copy ("to_host"), the npz
    write ("write") and the CRC manifest with the fsyncs ("seal")."""
    faults.fire("checkpoint.write", path=path, step=step)
    payload = {"params": params}
    if opt_state is not None:
        payload["opt_state"] = opt_state
    paths, leaves = _flatten_with_paths(payload)
    t0 = time.perf_counter()
    host = [_to_host(l) for l in leaves]
    t1 = time.perf_counter()

    tmp = f"{path}.tmp.{os.getpid()}"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    arrays = {f"leaf_{i}": a for i, (a, _) in enumerate(host)}
    with open(os.path.join(tmp, "arrays.npz"), "wb") as f:
        np.savez(f, **arrays)
        f.flush()
        t2 = time.perf_counter()
        os.fsync(f.fileno())
    meta = {
        "version": 1,
        "step": int(step),
        "paths": paths,
        "has_opt_state": opt_state is not None,
        "extra": extra or {},
        "dtypes": [name for _, name in host],
        "shapes": [list(a.shape) for a, _ in host],
    }
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump(meta, f)
        f.flush()
        os.fsync(f.fileno())
    write_manifest(tmp, extra={"step": int(step)})
    _fsync_dir(tmp)
    rule = faults.fire("checkpoint.finalize", path=path, step=step)
    if rule is not None and rule.action == "corrupt":
        # injected bit-rot AFTER the manifest: the swap proceeds and the
        # NEXT load must catch the mismatch by CRC
        npz = os.path.join(tmp, "arrays.npz")
        with open(npz, "r+b") as f:
            f.seek(max(os.path.getsize(npz) // 2, 0))
            f.write(b"\xde\xad\xbe\xef")

    # swap: live -> .prev (last-good fallback), tmp -> live. A crash
    # between the renames leaves only .prev: load_checkpoint falls back.
    prev = last_good_path(path)
    if os.path.isdir(path):
        if os.path.isdir(prev):
            shutil.rmtree(prev)
        os.rename(path, prev)
    os.rename(tmp, path)
    _fsync_dir(os.path.dirname(os.path.abspath(path)))
    if timings is not None:
        timings.update(to_host=t1 - t0, write=t2 - t1, seal=time.perf_counter() - t2)
    return path


def _load_verified(path: str, template_params: Any, template_opt_state: Any,
                   timings: Dict[str, float]) -> Tuple[Any, Any, int, Dict[str, Any]]:
    t0 = time.perf_counter()
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    host = _read_npz(os.path.join(path, "arrays.npz"),
                     [f"leaf_{i}" for i in range(len(meta["paths"]))])
    t1 = time.perf_counter()

    payload = {"params": template_params}
    if meta["has_opt_state"]:
        if template_opt_state is None:
            raise ValueError("checkpoint has opt_state; pass template_opt_state")
        payload["opt_state"] = template_opt_state
    t_paths, t_leaves = _flatten_with_paths(payload)
    if t_paths != meta["paths"]:
        missing = set(meta["paths"]) - set(t_paths)
        extra_k = set(t_paths) - set(meta["paths"])
        raise ValueError(
            f"checkpoint/template structure mismatch; missing={sorted(missing)[:3]} "
            f"extra={sorted(extra_k)[:3]}"
        )
    dtypes = meta.get("dtypes") or [str(a.dtype) for a in host]
    fixed = []
    for leaf_path, a, name, t in zip(t_paths, host, dtypes, t_leaves):
        tshape = tuple(t.shape) if hasattr(t, "shape") else tuple(np.shape(t))
        if tuple(a.shape) != tshape:
            # ZeRO weight-update sharding (parallel/zero.py) checkpoints
            # optimizer-state vector leaves as padded flats of
            # W*ceil(size/W) elements. Those restore value-preservingly
            # into the template's shape by stripping the zero pad, which
            # also makes the checkpoint world-size-portable (the step
            # re-pads for ITS world on first dispatch). A legit ZeRO pad is
            # all zeros and < one shard, bounded here by max(n, 256);
            # only OPTIMIZER-STATE leaves are ever saved padded-flat, and
            # a mis-sized PARAM leaf keeps the hard raise.
            n = int(np.prod(tshape, dtype=np.int64)) if tshape else 1
            tail = a[n:] if a.ndim == 1 else a
            if tail.dtype.kind == "V":  # raw words: test the bytes
                tail = tail.view(np.uint8)
            if (
                "opt_state" in leaf_path.split("/", 1)[0]
                and a.ndim == 1
                and a.size >= n
                and a.size - n <= max(n, 256)
                and not np.any(tail)
            ):
                a = a[:n].reshape(tshape)
            else:
                raise ValueError(
                    f"shape mismatch: checkpoint {a.shape} vs template "
                    f"{tshape} (flat leaves load only as ZeRO "
                    "padded-flats: 1-D, >= template size, bounded "
                    "zero-tail pad)"
                )
        fixed.append((a, name, t))
    t2 = time.perf_counter()
    restored = _py_unflatten(payload, [_from_host(a, name, t) for a, name, t in fixed])
    for leaf in _flatten_with_paths(restored)[1]:
        if isinstance(leaf, torch.Tensor) and leaf.device.type == "cuda":
            torch.cuda.synchronize(leaf.device)
            break
    timings.update(read=t1 - t0, to_device=time.perf_counter() - t2)
    return restored["params"], restored.get("opt_state"), meta["step"], meta.get("extra", {})


@numerics_contract(
    "bitwise",
    note="inverse of save_checkpoint: leaves come back in their "
    "manifest-recorded dtypes, byte-for-byte",
)
def load_checkpoint(
    path: str,
    template_params: Any,
    template_opt_state: Any = None,
    allow_fallback: bool = True,
    timings: Optional[Dict[str, float]] = None,
) -> Tuple[Any, Any, int, Dict[str, Any]]:
    """Load into the structure of the given templates; returns (params,
    opt_state, step, extra). Each leaf comes back as a tensor on its
    template leaf's device (a numpy template leaf: on the CPU), in the
    recorded dtype; a Python template leaf as its Python type.

    Every candidate is CRC-verified before deserialization; a corrupt
    live checkpoint is quarantined (`<path>.quarantine.<n>`) and, with
    `allow_fallback` (default), the last-good `<path>.prev` copy is loaded
    instead. Raises CheckpointCorruptError when nothing verifies,
    FileNotFoundError when nothing exists. A `timings` dict gets the
    seconds of the CRC check ("verify"), the npz read ("read") and the
    host-to-device copy ("to_device")."""
    candidates = [path]
    if allow_fallback:
        candidates.append(last_good_path(path))
    if not any(os.path.isdir(c) for c in candidates):
        raise FileNotFoundError(f"no checkpoint at {path}")
    timings = {} if timings is None else timings
    failures = []
    for i, cand in enumerate(candidates):
        if not os.path.isdir(cand):
            continue
        t0 = time.perf_counter()
        ok, detail = verify_checkpoint(cand, require=_PAYLOAD_FILES)
        if not ok and "vanished" in detail:
            # a concurrent save's atomic swap renamed files under our
            # read: re-verify the (possibly brand-new) live dir once
            ok, detail = verify_checkpoint(cand, require=_PAYLOAD_FILES)
        if ok:
            if i > 0:
                warnings.warn(
                    f"checkpoint {path} failed integrity verification "
                    f"({failures[-1][1] if failures else 'missing'}); "
                    f"loaded last-good fallback {cand}",
                    RuntimeWarning,
                    stacklevel=2,
                )
            verify_s = time.perf_counter() - t0
            timings["verify"] = verify_s
            out = _load_verified(cand, template_params, template_opt_state, timings)
            return out
        failures.append((cand, detail))
        # never quarantine on a transient verdict (racing writer): only a
        # checkpoint whose bytes verifiably mismatch is moved aside
        q = None if "vanished" in detail else _quarantine(cand)
        warnings.warn(
            f"corrupt checkpoint {cand}: {detail}" + (f"; quarantined to {q}" if q else ""),
            RuntimeWarning,
            stacklevel=2,
        )
    raise CheckpointCorruptError(
        "no loadable checkpoint: " + "; ".join(f"{c}: {d}" for c, d in failures)
    )
