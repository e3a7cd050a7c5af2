"""Disaggregated prefill/decode serving.

Two HETEROGENEOUS engine pools — prefill and decode, each with its own
replica count and TP mesh — joined by a KV MIGRATION plane: a finished
prefill's paged blocks (int8 payloads + scale planes included, raw)
stream from the prefill pool to the decode pool in planner-scheduled
chunks (`plan/transfer.py`), land with an `attach`-style table stitch
(`ServeEngine.attach_migrated`), and decode continues FROM the
already-sampled first token with the RNG carry reconstructed purely
from the request seed (`serve/decode.py::carry_key`). Token-exact by
construction vs the colocated engine — the `disagg_migration` numlint
subject sweeps (prefill TP × decode TP × kv_quant) geometries to
enforce it.

* `migrate.py` — the migration plane: idempotent store publication
  (`serve/migrate/{rid}` manifests over chunk keys, payload-before-
  manifest), the landing path, orphan GC.
* `router.py` — `PoolRouter` (one pool's replica set, the
  router surface the autoscaler drives) and `DisaggRouter` (the
  two-pool front door: submit → prefill → migrate → decode →
  complete, with preempted migrants replayed from seed through the
  prefill pool).

Pool membership at PROCESS granularity is a generation-scoped store
claim (`serve/worker.py::claim_role`); this package is the in-process
plane the deterministic tests and benchmarks drive.
"""

from .migrate import (
    gc_migration,
    migrate_request,
    pending_rids,
    recv_migration,
    send_handoff,
)
from .router import DisaggRouter, PoolRouter

__all__ = [
    "DisaggRouter",
    "PoolRouter",
    "migrate_request",
    "send_handoff",
    "recv_migration",
    "gc_migration",
    "pending_rids",
]
