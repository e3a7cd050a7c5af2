"""Continuous-batching serving on one device, the port of the reference's
`serve/` subsystem so far: the paged block-pool KV cache with refcounts
and copy-on-write (`cache.py`), the decode programs (`decode.py`), the
scheduler with chunked prefill, preemption, classes and prefix sharing
(`engine.py`), the request queue (`queue.py`), bucketed prefill shapes
(`bucketing.py`), the metrics block (`metrics.py`) and the radix prefix
index (`prefix.py`). Tensor-parallel and disaggregated serving, the
router, autoscaling, elastic restore, pre-warming and the worker daemon
are still to come (ROADMAP.md, Queue 1).
"""

from .bucketing import bucket_for, bucket_lengths  # noqa: F401
from .cache import PagedKVCache, SlotKVCache, init_paged_cache, land_slot  # noqa: F401
from .decode import carry_key, paged_programs, slot_programs, sync_slot_lanes  # noqa: F401
from .engine import ServeEngine  # noqa: F401
from .metrics import ServeMetrics, percentile  # noqa: F401
from .prefix import PrefixIndex, prefix_scope  # noqa: F401
from .queue import ClassSpec, Completion, QueueFullError, Request, RequestQueue  # noqa: F401
