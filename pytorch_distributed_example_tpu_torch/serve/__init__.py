"""Continuous-batching serving, the port of the reference's `serve/`
subsystem: the paged block-pool KV cache with refcounts and
copy-on-write (`cache.py`), the decode programs (`decode.py`), the
scheduler with chunked prefill, preemption, classes, prefix sharing,
tensor-parallel decode (``mesh=``) and the disaggregated roles
(`engine.py`), the request queue (`queue.py`), bucketed prefill shapes
(`bucketing.py`), the metrics block (`metrics.py`), the radix prefix
index (`prefix.py`), the serve-state checkpoints (`elastic.py`), the
data-parallel replica router (`router.py`) with its SLO autoscaler
(`autoscale.py`), and disaggregated prefill/decode pools joined by KV
migration (`disagg/`), the serve worker daemon under the elastic agent
with its front door and gang scaler (`worker.py`), and the geometry
pre-warm (`prewarm.py`).
"""

from .bucketing import bucket_for, bucket_lengths  # noqa: F401
from .cache import PagedKVCache, SlotKVCache, init_paged_cache, land_slot  # noqa: F401
from .decode import carry_key, paged_programs, slot_programs, sync_slot_lanes  # noqa: F401
from .elastic import (  # noqa: F401
    drain_requested,
    gc_serve_state,
    load_serve_state,
    restore_into,
    save_serve_state,
    signal_drain,
)
from .autoscale import AutoscalePolicy, Autoscaler, Decision  # noqa: F401
from .engine import Handoff, ServeEngine  # noqa: F401
from .metrics import ServeMetrics, percentile  # noqa: F401
from .prefix import PrefixIndex, prefix_scope  # noqa: F401
from .router import ScaleEvent, ServeRouter  # noqa: F401
from .worker import (  # noqa: F401
    ElasticGangScaler,
    GangRouter,
    ServeWorker,
    claim_role,
    pool_members,
    wait_registered,
)
from .prewarm import (  # noqa: F401
    GeometrySpec,
    enable_compile_cache,
    load_precompiled,
    prewarm_engine_programs,
    reachable_geometries,
)
from .queue import ClassSpec, Completion, QueueFullError, Request, RequestQueue  # noqa: F401
