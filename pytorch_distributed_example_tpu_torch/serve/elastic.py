"""Elastic serving — drain / checkpoint / restore of the serve plane.

The failure domain this module closes: an
elastic-agent restart or resize used to kill every in-flight request
and lose the queue. Now the serving state that actually matters —
which requests exist, not what their KV blocks hold — survives the
gang:

* **drain** — `ServeEngine.drain()` stops at a step boundary (the
  `serve/decode.py` quiesce seam), requeues in-flight work, and emits a
  JSON-able snapshot: every queued request's (prompt, seed, token
  budget, tenant/class, arrival, requeue count) plus the emitted-token
  ledger and the checkpoint timestamp.
* **checkpoint** — `save_serve_state` writes that snapshot into the
  coordination store under an INCARNATION-SCOPED key
  (``serve/ckpt/gen{g}``) with the checkpoint integrity conventions adapted
  to a store: one atomic `set` per generation (a store write is all-or-
  nothing, the rename-equivalent), a CRC32+size header sealed over the
  payload (the manifest), and an overwritten ``serve/ckpt/latest``
  pointer. Nothing is ever half-visible; a torn writer leaves the
  previous generation's sealed blob untouched.
* **restore** — `load_serve_state` walks generations newest-first from
  the pointer, verifying each blob's CRC and falling back to the
  newest earlier generation that verifies (the `checkpoint_sharded.py`
  newest-verified-step discipline); `restore_into` replays the
  snapshot into a fresh engine on the re-formed gang. The new gang may
  have a DIFFERENT world size or TP degree: the snapshot carries no
  device state at all — every request replays token-identically from
  its seed, which is what makes resize-safety free.

Recovery time is a first-class metric: the snapshot's drain timestamp
anchors a window that the restored engine closes at its first emitted
token, reported under ``recovery`` on ``/serve``. Both engines must
share a clock timebase (``time.time`` across processes; any fake clock
within one).

Fault points: ``serve.drain`` (before the snapshot is cut — engine
untouched on a transient fault) and ``serve.restore`` (before the
checkpoint is read back).

A copy of the reference's `serve/elastic.py`, re-pointed at the port's
`faults`, `serve.queue` and elastic agent.
"""

from __future__ import annotations

import json
import warnings
import zlib
from typing import Dict, Optional, Tuple

from .. import faults
from ..elastic.agent import SERVE_DRAIN_PREFIX  # agent owns the contract
from .queue import Request

__all__ = [
    "save_serve_state",
    "load_serve_state",
    "gc_serve_state",
    "restore_into",
    "drain_requested",
    "signal_drain",
    "SERVE_CKPT_PREFIX",
    "SERVE_DRAIN_PREFIX",
]

SERVE_CKPT_PREFIX = "serve/ckpt"


def _ckpt_key(gen: int, key_prefix: str = SERVE_CKPT_PREFIX) -> str:
    return f"{key_prefix}/gen{gen}"


def _seal(state: Dict) -> bytes:
    """CRC-manifest framing: `{"crc32": ..., "size": ...}\\n<payload>`.
    The header is written WITH the payload in one store set — the
    atomicity the checkpoint file layer gets from tmp+rename, a store gets
    from single-key writes."""
    payload = json.dumps(state, sort_keys=True).encode()
    header = json.dumps(
        {"crc32": zlib.crc32(payload) & 0xFFFFFFFF, "size": len(payload)}
    ).encode()
    return header + b"\n" + payload


def _unseal(blob: bytes) -> Optional[Dict]:
    """Verify the CRC manifest; None on ANY mismatch (corrupt blobs are
    a fallback decision, never an exception)."""
    try:
        header, _, payload = blob.partition(b"\n")
        meta = json.loads(header)
        if len(payload) != int(meta["size"]):
            return None
        if (zlib.crc32(payload) & 0xFFFFFFFF) != int(meta["crc32"]):
            return None
        return json.loads(payload)
    except (ValueError, KeyError, TypeError):
        return None


def save_serve_state(
    store, gen: int, state: Dict, key_prefix: str = SERVE_CKPT_PREFIX
) -> str:
    """Persist a `ServeEngine.drain()` snapshot for generation `gen`.

    One atomic set per generation key + an overwritten latest pointer;
    earlier generations stay sealed in place as the fallback chain.
    `key_prefix` namespaces independent serve planes on one store —
    the DP router seals each drained REPLICA's snapshot
    under its own prefix, so replica checkpoints can never clobber the
    whole-plane chain (or each other). Returns the key written."""
    key = _ckpt_key(gen, key_prefix)
    store.set(key, _seal(dict(state, generation=int(gen))))
    # the pointer is a single overwritten key (the incarnation scope
    # lives in the per-generation blobs it points AT)
    store.set(f"{key_prefix}/latest", str(int(gen)).encode())  # storelint: disable=S005 -- single overwritten per-plane pointer; the CRC-fallback walk anchors on it, and the gens below it ARE GC'd
    return key


def load_serve_state(
    store,
    upto_gen: Optional[int] = None,
    max_back: int = 8,
    key_prefix: str = SERVE_CKPT_PREFIX,
) -> Tuple[Optional[Dict], int]:
    """Read back the newest VERIFIED serve checkpoint.

    Starts at the latest pointer (or `upto_gen`) and walks generations
    downward: a blob that fails its CRC manifest is warned about and
    skipped — the newest earlier generation that verifies wins (the
    last-good fallback). `key_prefix` selects the plane (see
    `save_serve_state`). Returns (state, generation) or (None, -1)
    when nothing restorable exists (a fresh gang starts empty)."""
    faults.fire("serve.restore", upto_gen=upto_gen)
    start = upto_gen
    if start is None:
        try:
            if not store.check([f"{key_prefix}/latest"]):
                return None, -1
            start = int(store.get(f"{key_prefix}/latest").decode())
        except Exception:
            return None, -1
    for gen in range(int(start), max(int(start) - max_back, -1), -1):
        key = _ckpt_key(gen, key_prefix)
        try:
            if not store.check([key]):
                continue
            blob = store.get(key)
        except Exception:
            continue
        state = _unseal(blob)
        if state is not None:
            if gen != start:
                warnings.warn(
                    f"serve checkpoint gen{start} missing or corrupt; "
                    f"restored last-good gen{gen}",
                    RuntimeWarning,
                    stacklevel=2,
                )
            return state, gen
        warnings.warn(
            f"serve checkpoint {key} failed CRC verification; "
            f"falling back",
            RuntimeWarning,
            stacklevel=2,
        )
    return None, -1


def gc_serve_state(
    store,
    verified_gen: int,
    keep: int = 2,
    key_prefix: str = SERVE_CKPT_PREFIX,
    max_scan: int = 32,
) -> int:
    """Reclaim sealed generation blobs the fallback chain can no longer
    need: every generation strictly older than ``verified_gen - keep``.

    `verified_gen` must be a generation that VERIFIED on read-back (the
    one `load_serve_state` just returned) — GC anchored on the latest
    pointer instead would let a torn/corrupt newest blob strand the
    plane with nothing restorable once its predecessors are reclaimed.
    Keeping `keep` generations below the verified one preserves the
    CRC-fallback property across the next few seals: if the NEXT
    sealed generation lands corrupt, `load_serve_state` still walks
    back onto blobs this GC was forbidden to touch. Returns the number
    of blobs reclaimed; never raises (a flaky store just defers the
    reclaim to the next restore)."""
    if verified_gen < 0 or keep < 0:
        return 0
    floor = int(verified_gen) - int(keep)  # oldest generation KEPT
    reclaimed = 0
    for gen in range(floor - 1, max(floor - 1 - int(max_scan), -1), -1):
        key = _ckpt_key(gen, key_prefix)
        try:
            if store.check([key]) and store.delete_key(key):
                reclaimed += 1
        except Exception:
            break  # store trouble: stop here, retry at the next restore
    return reclaimed


def restore_into(engine, state: Dict, generation: int = -1) -> int:
    """Replay a drain snapshot into a fresh engine on the re-formed
    gang (any world size / TP degree — the snapshot is device-free).

    Engine-accepted work (the snapshot's "requests": in-flight +
    requeued) re-enters through `requeue_front` in reverse order —
    bounds must not shed it. The never-admitted submitted backlog
    ("queued") re-enters through `restore_tail`, staying visible to
    the depth bound and class-ordered shedding exactly as it was
    before the restart (a restored bronze backlog must not become
    immune to gold's overload shed). Arms the recovery-time window —
    the engine closes it at its first emitted token; a snapshot with
    nothing to restore records a zero-length recovery immediately
    instead of arming a window that later unrelated traffic would
    close bogusly. Returns the number of requests restored."""
    reqs = [Request.from_state(d) for d in state.get("requests", [])]
    for req in reversed(reqs):
        engine.queue.requeue_front(req)
    queued = [Request.from_state(d) for d in state.get("queued", [])]
    for req in queued:
        engine.queue.restore_tail(req)
    n = len(reqs) + len(queued)
    emitted = state.get("emitted", {})
    if n:
        engine._recovery_anchor = float(state.get("checkpoint_time", 0.0))
        engine._recovery_meta = (
            n,
            int(sum(emitted.values())),
            int(generation),
        )
    else:
        engine.metrics.record_recovery(0.0, 0, 0, int(generation))
    return n


# ---------------------------------------------------------------------------
# Cooperative drain signalling (agent <-> serve loop)
# ---------------------------------------------------------------------------


def signal_drain(store, gen: int) -> None:
    """Agent side: ask generation `gen`'s serve loops to drain and
    checkpoint before the teardown deadline (`WorkerSpec.
    serve_drain_grace_s`). Generation-scoped — a re-formed gang never
    sees a stale drain request."""
    store.set(f"{SERVE_DRAIN_PREFIX}/gen{gen}", b"1")


def drain_requested(store, gen: int) -> bool:
    """Serve-loop side: poll between steps; True once the agent has
    asked this generation to drain."""
    try:
        return bool(store.check([f"{SERVE_DRAIN_PREFIX}/gen{gen}"]))
    except Exception:
        return False
