"""Live KV migration between serve pools — the disagg data plane.

A migration moves ONE finished prefill (a frozen `serve/engine.py::
Handoff`) from a prefill-pool engine to a decode-pool engine through
the store, in three idempotent moves:

1. **publish** (`send_handoff`) — export the slot's paged blocks raw
   (`PagedKVCache.export_blocks`: int8 payloads and their f32 scale
   planes bit-for-bit), cut them into planner-scheduled chunks
   (`plan/transfer.py::schedule_migration` — the chunk order IS the
   plan's round-major walk) and publish each under
   ``serve/migrate/{rid}/chunk{i}``, then seal the MANIFEST
   (``serve/migrate/{rid}``: request state, prompt length, the
   first token the prefill engine already sampled, the TTFT stamp,
   chunk count, plan fingerprint) LAST. Payload-before-manifest is the
   storelint S007 discipline: a reader that sees the manifest sees
   every chunk. Replays write byte-identical values — publication is
   idempotent, so a transient fault at `serve.migrate.send` simply
   retries.
2. **land** (`recv_migration`) — `serve.migrate.recv` fires before
   anything is read or mutated; then the chunks reassemble in offset
   order and `ServeEngine.attach_migrated` stitches them into the
   decode engine's own block table with the carry key rebuilt from the
   seed. A retried receive re-lands the same bytes; a decode engine
   with no capacity refuses (None) with the payload intact for the
   next attempt.
3. **reclaim** (`gc_migration`) — after the landing (or for orphans of
   crashed/requeued requests) the manifest and chunks are deleted.
   The consumer deletes what the producer published: the
   ``serve/migrate/*`` family is self-balancing under storelint.

`migrate_request` composes the three under the ``token_exact``
numerics contract — the decode pool's emitted stream must be bitwise
the colocated engine's (the reference's `disagg_migration` numlint
subject sweeps this across prefill-TP × decode-TP × kv_quant
geometries).

A copy of the reference's `serve/disagg/migrate.py`: the same keys, the
same manifest, the same CRC framing. Two things differ. The payload
tree's leaves are CPU torch tensors (`PagedKVCache.export_blocks`), and
numpy, which writes the `.npz` chunk bodies, has no bfloat16: a bf16
leaf travels as its raw 16-bit words, with the dtypes of such leaves
recorded in the blob's ``__dtypes__`` entry, so a republication is byte
for byte the first and the landed pool is bit for bit the prefill
pool's. The block slicing and reassembly walk the nested dict where the
reference maps `jax.tree_util`.
"""

from __future__ import annotations

import io
import json
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ... import faults
from ...numerics import numerics_contract
from ...plan.transfer import chunk_spans, schedule_migration
from ..queue import Request

__all__ = [
    "send_handoff",
    "recv_migration",
    "migrate_request",
    "gc_migration",
    "pending_rids",
    "MIGRATE_PREFIX",
]

MIGRATE_PREFIX = "serve/migrate"


def _mig_key(rid: str) -> str:
    return f"{MIGRATE_PREFIX}/{rid}"


def _chunk_key(rid: str, i: int) -> str:
    return f"{MIGRATE_PREFIX}/{rid}/chunk{i}"


# -- payload framing --------------------------------------------------------
_DTYPES_KEY = "__dtypes__"
# dtypes numpy cannot hold, carried as raw words of the same width
_RAW = {torch.bfloat16: torch.int16}


def _walk(tree, fn):
    """Map `fn` over the leaves of a nested dict."""
    if isinstance(tree, dict):
        return {k: _walk(v, fn) for k, v in tree.items()}
    return fn(tree)


def _pack_tree(tree) -> bytes:
    """Flatten a pool-payload tree into one .npz blob, keys =
    '/'-joined paths in sorted order (deterministic bytes for a
    deterministic tree — republication must be byte-identical). A leaf
    whose dtype numpy lacks goes as its raw words, its dtype named under
    ``__dtypes__``."""
    flat: Dict[str, np.ndarray] = {}
    raw: Dict[str, str] = {}

    def walk(prefix: str, node) -> None:
        if isinstance(node, dict):
            for k in sorted(node):
                walk(f"{prefix}/{k}" if prefix else k, node[k])
            return
        t = torch.as_tensor(node).detach().cpu().contiguous()
        if t.dtype in _RAW:
            raw[prefix] = str(t.dtype).removeprefix("torch.")
            t = t.view(_RAW[t.dtype])
        flat[prefix] = t.numpy()

    walk("", tree)
    if raw:
        flat[_DTYPES_KEY] = np.asarray(json.dumps(raw, sort_keys=True))
    buf = io.BytesIO()
    np.savez(buf, **flat)
    return buf.getvalue()


def _unpack_tree(blob: bytes):
    """The tree `_pack_tree` packed, its leaves CPU torch tensors in their
    recorded dtypes."""
    with np.load(io.BytesIO(blob), allow_pickle=False) as z:
        raw = json.loads(str(z[_DTYPES_KEY])) if _DTYPES_KEY in z.files else {}
        tree: Dict = {}
        for key in z.files:
            if key == _DTYPES_KEY:
                continue
            t = torch.from_numpy(np.array(z[key]))
            if key in raw:
                t = t.view(getattr(torch, raw[key]))
            parts = key.split("/")
            node = tree
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = t
    return tree


def _seal_chunk(meta: Dict, payload: bytes) -> bytes:
    """CRC-manifest framing for a binary chunk — the `serve/elastic.py`
    `_seal` convention extended to a non-JSON payload."""
    header = json.dumps(
        dict(
            meta,
            crc32=zlib.crc32(payload) & 0xFFFFFFFF,
            size=len(payload),
        ),
        sort_keys=True,
    ).encode()
    return header + b"\n" + payload


def _unseal_chunk(blob: bytes) -> Optional[Tuple[Dict, bytes]]:
    try:
        header, _, payload = blob.partition(b"\n")
        meta = json.loads(header)
        if len(payload) != int(meta["size"]):
            return None
        if (zlib.crc32(payload) & 0xFFFFFFFF) != int(meta["crc32"]):
            return None
        return meta, payload
    except (ValueError, KeyError, TypeError):
        return None


def _slice_blocks(payload, off: int, n: int):
    """Cut a block-payload tree to blocks [off, off+n) along the block
    axis (axis 0 of every array leaf)."""
    return _walk(payload, lambda a: a[off : off + n] if a.dim() else a)


# -- the three idempotent moves --------------------------------------------
def send_handoff(
    store,
    engine,
    h,
    *,
    prefill_world: int = 1,
    decode_world: int = 1,
    chunk_blocks: int = 4,
) -> int:
    """Publish handoff `h`'s KV payload + manifest; returns the chunk
    count. IDEMPOTENT: every key's value is a pure function of the
    frozen slot's bytes, so a replay (transient fault, crashed sender
    re-driven by the re-formed gang) rewrites identical blobs.
    `serve.migrate.send` fires BEFORE anything is exported or
    published — with the slot still frozen, a fault here costs only a
    retry, and a crash replays the whole request from seed."""
    rid = h.req.rid
    blocks = engine.cache.slot_blocks(h.slot)
    faults.fire(
        "serve.migrate.send", rid=rid, blocks=len(blocks), slot=h.slot
    )
    payload = engine.cache.export_blocks(blocks)
    plan = schedule_migration(
        len(blocks), prefill_world, decode_world, chunk_blocks
    )
    spans = list(chunk_spans(plan))
    for i, (_rnd, _src, _dst, off, n) in enumerate(spans):
        store.set(
            _chunk_key(rid, i),
            _seal_chunk(
                {"rid": rid, "chunk": i, "off": off, "n": n},
                _pack_tree(_slice_blocks(payload, off, n)),
            ),
        )
    manifest = json.dumps(
        {
            "rid": rid,
            "req": h.req.to_state(),
            "length": int(h.length),
            "first": int(h.first),
            "first_token_time": (
                float(h.req.first_token_time)
                if h.req.first_token_time is not None
                else None
            ),
            "n_blocks": len(blocks),
            "n_chunks": len(spans),
            "chunk_blocks": int(chunk_blocks),
            "plan": plan.fingerprint(),
        },
        sort_keys=True,
    ).encode()
    # manifest LAST (payload-before-manifest): a reader that sees this
    # key sees every chunk it indexes
    store.set(_mig_key(rid), manifest)
    return len(spans)


def recv_migration(store, rid: str, engine) -> Optional[int]:
    """Land migration `rid` on (decode-pool) `engine`; returns the slot
    or None (manifest not yet published, a chunk corrupt/missing, or
    the engine has no capacity right now — in every case NOTHING was
    mutated and the payload stays put for the next attempt).
    `serve.migrate.recv` fires first: a transient fault retries with
    the store payload intact, re-landing the same bytes."""
    faults.fire("serve.migrate.recv", rid=rid)
    try:
        if not store.check([_mig_key(rid)]):
            return None
        meta = json.loads(store.get(_mig_key(rid)))
    except faults.FaultTimeout:
        raise
    except Exception:
        return None
    parts: List[Tuple[int, Dict]] = []
    for i in range(int(meta["n_chunks"])):
        try:
            # probe first: a torn chunk must not park the decode pool
            # on the store's blocking-get timeout
            if not store.check([_chunk_key(rid, i)]):
                return None
            got = _unseal_chunk(store.get(_chunk_key(rid, i)))
        except Exception:
            got = None
        if got is None:
            return None  # torn publication: sender will republish
        cmeta, blob = got
        parts.append((int(cmeta["off"]), _unpack_tree(blob)))
    parts.sort(key=lambda p: p[0])
    if parts:
        trees = [p[1] for p in parts]

        def join(path, node):
            if isinstance(node, dict):
                return {k: join(path + (k,), v) for k, v in node.items()}
            leaves = []
            for t in trees:
                for k in path:
                    t = t[k]
                leaves.append(t)
            return torch.cat(leaves, dim=0) if leaves[0].dim() else leaves[0]

        payload = join((), trees[0])
    else:
        payload = {}
    req = Request.from_state(meta["req"])
    if meta.get("first_token_time") is not None:
        # TTFT happened on the prefill pool; the completion's
        # accounting must span pools, not restart at the landing
        req.first_token_time = float(meta["first_token_time"])
    return engine.attach_migrated(
        req, int(meta["length"]), int(meta["first"]), payload
    )


def gc_migration(store, rid: str) -> int:
    """Delete migration `rid`'s manifest + chunks (post-landing
    reclaim, and the orphan sweep for requests that crashed or
    requeued mid-migration — their replay goes through prefill again
    and republishes from scratch). Returns keys deleted. Probes chunk
    keys past the manifest's count so a torn publication (chunks
    written, manifest never landed) still reclaims fully."""
    deleted = 0
    n = 0
    try:
        if store.check([_mig_key(rid)]):
            n = int(json.loads(store.get(_mig_key(rid))).get("n_chunks", 0))
    except Exception:
        pass
    i = 0
    while True:
        try:
            if store.delete_key(_chunk_key(rid, i)):
                deleted += 1
            elif i >= n:
                break
        except Exception:
            break
        i += 1
    try:
        if store.delete_key(_mig_key(rid)):
            deleted += 1
    except Exception:
        pass
    return deleted


def pending_rids(store, rids) -> List[str]:
    """Which of `rids` still have a published manifest — the orphan
    scan (`DisaggRouter` sweeps completions' and requeued requests'
    rids through `gc_migration`)."""
    out = []
    for rid in rids:
        try:
            if store.check([_mig_key(rid)]):
                out.append(rid)
        except Exception:
            pass
    return out


@numerics_contract(
    "token_exact",
    note="a migrated request's decode-pool token stream is bitwise the "
    "colocated engine's: blocks move raw (int8 + scales), the first "
    "token was already sampled on the prefill mesh, and the RNG carry "
    "is a pure function of the seed (serve/decode.py::carry_key) — "
    "swept across prefill-TP x decode-TP x kv_quant by the "
    "reference's disagg_migration numlint subject",
)
def migrate_request(
    store,
    src_engine,
    dst_engine,
    h,
    *,
    prefill_world: int = 1,
    decode_world: int = 1,
    chunk_blocks: int = 4,
) -> Optional[int]:
    """One full migration: publish → land → release the frozen source
    slot → reclaim the store keys. Returns the decode-side slot, or
    None when the decode engine cannot hold the request yet — the
    payload stays PUBLISHED and the source slot stays FROZEN, so the
    caller retries the landing (possibly on another replica) without
    re-exporting."""
    send_handoff(
        store,
        src_engine,
        h,
        prefill_world=prefill_world,
        decode_world=decode_world,
        chunk_blocks=chunk_blocks,
    )
    slot = recv_migration(store, h.req.rid, dst_engine)
    if slot is None:
        return None
    # landing is durable in the decode engine before the source frees
    # anything; a crash between these two moves costs only a leaked
    # frozen slot until the gang re-forms and replays from seed
    src_engine.release_handoff(h)
    gc_migration(store, h.req.rid)
    return slot
