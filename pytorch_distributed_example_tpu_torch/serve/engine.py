"""ServeEngine — continuous-batching scheduler over the paged KV cache,
the port of the reference's `serve/engine.py`.

Requests enter a bounded queue (`serve/queue.py`), are admitted into cache
slots whose memory is paged from a shared block pool (`serve/cache.py`:
allocated on write, freed at retire), are prefilled in chunks interleaved
with decode (`prefill_chunk_tokens` bounds the prompt work of one step),
and then every decoding slot advances one token per `step()` through the
paged decode step (`serve/decode.py`). Retirement frees the slot and its
blocks, and admission backfills mid-stream.

Pool pressure resolves by preemption, worst class then youngest first:
the victim's blocks are freed and it is requeued at the head, to replay
later from its own seed, token for token. `submit()` refuses a request
whose worst case exceeds the whole pool, so the oldest request can always
finish. ``kv_quant=True`` switches the pool to int8 (quantize on scatter,
dequantize in the gather). ``prefix_cache=True`` attaches the longest
cached prompt prefix's blocks at admission (`serve/prefix.py`), so
chunked prefill starts at the first uncached position; divergence inside
a shared or indexed block copies that block first. ``classes=`` gives
weighted admission across priority classes, class-ordered shedding and
cross-class preemption. `drain()` stops at a step boundary, requeues all
in-flight work and returns a JSON-able snapshot; `snapshot_state()` takes
the snapshot alone.

Every tensor of the engine (the pool, the (S,) lanes of lengths, last
tokens and rng keys) lives on the model's device, which is cuda:0 unless
the model was built elsewhere: each step reads back only the (S,) next
tokens, and a prefill's end reads back its first token, as the
reference's. Prefill runs the same dense decode-path attention as the
reference's programs (no flash kernel on this path).

Tensor-parallel decode: ``mesh=`` (a `DeviceMesh` with a ``tp_axis`` axis
of T ranks) lays the weights out once, at construction, by
`models.transformer.sharding_rules(tp_axis, fsdp_axis=None)`
(`TensorParallelDecoder`, the MoE's experts split on their hidden dim),
shards the block pool on its KV heads
(`parallel.tensor_parallel.shard_kv_pool`) and holds the slot lanes
replicated. The programs are the single-card ones over that decoder.
``params=`` (name -> `DTensor` over `mesh`, as
`dtensor.redistribute_for_serving` gives) serves those weights in place of
the model's own. A driver-mode mesh holds every tp rank on the model's
device, and the engine acts for all of them. Over a multiproc mesh
(`init_device_mesh(("tp",), (T,))` in a gang, one process a tp rank) each
process runs its own engine on the same traffic: the host-side slot
bookkeeping and block tables are identical on every process (every
decision is a deterministic function of the submitted requests and the
tokens, which are the same everywhere), each process holds its KV-head
shard of the pool and a full copy of the slot lanes, and sampling draws
from the same threefry keys on every process, so every process emits the
same tokens. The decoder's collectives are the tp group's.

Disaggregated serving (`serve/disagg/`): ``role="prefill"`` freezes each
finished prefill as a `Handoff` (slot, blocks and first token kept, no
decoding) for the migration plane, which exports its blocks and calls
`release_handoff`; ``role="decode"`` admits work only through
`attach_migrated` (its queue holds preempted migrants for the router to
replay through prefill); ``role="both"`` is the colocated engine.

Pre-warm: ``precompiled=`` takes `serve/prewarm.py`'s table (from
`load_precompiled`) and runs each listed program call once at
construction, on scratch lanes and the pool's sink block, so the first
token after a resize pays no first-call cost; dispatch stays the eager
programs (the reference swaps in deserialized executables instead).

Synchronous single-owner design: one thread calls `submit()`/`step()`/
`run()`; `ServeMetrics` is internally locked.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import faults
from ..models.generate import model_device
from ..numerics import numerics_contract
from ..types import DistError
from .bucketing import bucket_for, bucket_lengths
from .cache import PagedKVCache
from .decode import paged_programs, sync_slot_lanes
from .metrics import ServeMetrics
from .queue import (
    DEFAULT_CLASS,
    ClassSpec,
    Completion,
    QueueFullError,
    Request,
    RequestQueue,
)

__all__ = ["Handoff", "ServeEngine"]

# Faults the engine absorbs by requeueing work (the retry layer's
# transient taxonomy): injected connection resets and dropped requests.
# DistError "error" faults and real programming errors propagate.
_TRANSIENT = (ConnectionResetError, faults.FaultTimeout)


@dataclass
class _Prefill:
    """A slot mid-prefill: `pos` is the next prompt position to chunk
    (nonzero when a prefix-cache attach covered the prompt head); the
    request is not decoding (its lane stays parked) until the last
    chunk lands and `attach` seeds its state lanes."""

    req: Request
    pos: int = 0


@dataclass
class Handoff:
    """A finished prefill frozen for migration (``role="prefill"``
    engines, `serve/disagg/`): the slot keeps its blocks and request
    binding (nothing decodes, nothing frees) until the migration plane
    exports the KV payload and `release_handoff` returns the slot to the
    pool. `first` is the token the prefill engine already sampled (its
    one key split off `req.seed`), so the decode pool starts from it
    with the carry key rebuilt from the seed alone
    (`serve/decode.py::carry_key`): no device RNG state crosses."""

    req: Request
    slot: int
    length: int
    first: int


class ServeEngine:
    def __init__(
        self,
        model,
        slots: int = 8,
        temperature: float = 0.0,
        top_k: Optional[int] = None,
        eos_id: Optional[int] = None,
        min_bucket: int = 16,
        clock=time.monotonic,
        metrics: Optional[ServeMetrics] = None,
        block_size: int = 16,
        pool_blocks: Optional[int] = None,
        prefill_chunk_tokens: Optional[int] = None,
        max_queue_depth: Optional[int] = None,
        mesh=None,
        tp_axis: str = "tp",
        kv_quant: bool = False,
        conservative_admission: bool = False,
        classes: Optional[Dict[str, ClassSpec]] = None,
        class_preemption: bool = True,
        prefix_cache: bool = False,
        precompiled=None,
        role: str = "both",
        params=None,
    ):
        """`model` is a `TransformerLM` carrying its weights (the
        reference's `(model, params, ...)`); the engine runs on its
        device. The other arguments are the reference's; `params`
        (name -> `DTensor` over `mesh`) applies with `mesh=` only."""
        # disaggregated serving (serve/disagg/): "prefill" freezes
        # finished prefills as Handoffs for the migration plane instead
        # of decoding them; "decode" admits work only via
        # attach_migrated (its queue holds preempted migrants awaiting
        # router pickup); "both" is the colocated engine.
        if role not in ("both", "prefill", "decode"):
            raise ValueError(
                f"role must be 'both', 'prefill', or 'decode', got {role!r}"
            )
        if params is not None and mesh is None:
            raise ValueError("params= gives the weights' tensor-parallel layout; it needs "
                             "mesh=")
        self.role = role
        self._handoff: List[Handoff] = []
        self.mesh = mesh
        self.model = model
        self.cfg = model.cfg
        self.temperature = temperature
        self.top_k = top_k
        self.eos_id = eos_id
        self.clock = clock
        self.cache = PagedKVCache(
            model, slots, num_blocks=pool_blocks, block_size=block_size,
            quantized=kv_quant,
        )
        # prefix sharing: radix index over the refcounted pool, opt-in
        if prefix_cache:
            from .prefix import PrefixIndex

            self.prefix = PrefixIndex(self.cache)
        else:
            self.prefix = None
        # multi-tenant classes: weighted admission + class-ordered shed
        # in the queue; cross-class preemption here. None = the single
        # default class (FIFO).
        self.classes = dict(classes) if classes else None
        self.class_preemption = bool(classes) and class_preemption
        self.queue = RequestQueue(
            max_depth=max_queue_depth, classes=self.classes
        )
        self.metrics = metrics or ServeMetrics(
            clock=clock, slots=slots, classes=self.classes
        )
        self.metrics.slots = slots
        # displaced-by-class sheds (queued low-class work evicted by a
        # higher-class put), bounded to the newest _max_shed_kept
        self.shed_requests: Dict[str, Request] = {}
        self._max_shed_kept = 1024
        # elastic restore bookkeeping: the first post-restore emitted
        # token closes the recovery window
        self._recovery_anchor: Optional[float] = None
        self._recovery_meta: tuple = (0, 0, -1)
        self.buckets = bucket_lengths(self.cfg.max_seq_len, min_bucket)
        if prefill_chunk_tokens is not None and prefill_chunk_tokens < 1:
            raise ValueError(
                f"prefill_chunk_tokens must be >= 1, got "
                f"{prefill_chunk_tokens}"
            )
        self.prefill_chunk_tokens = prefill_chunk_tokens
        # conservative admission: reserve every request's worst-case
        # block footprint at admission, so pool-pressure preemption
        # never fires; `_reserved` tracks the active set's total
        self.conservative_admission = conservative_admission
        self._reserved = 0
        self.decoder = None
        if mesh is not None:
            from ..models.transformer import TensorParallelDecoder
            from ..parallel.tensor_parallel import shard_kv_pool

            # the weights go to the tp layout once, here; every program
            # call reads them as they are
            self.decoder = TensorParallelDecoder(model, mesh, params=params,
                                                 tp_axis=tp_axis)
            self.cache.tree = shard_kv_pool(self.cache.tree, mesh, axis=tp_axis)
        (
            self._prefill_chunk,
            self._first_token,
            self._attach,
            self._step,
        ) = paged_programs(model, temperature, top_k, forward=self.decoder)
        S = slots
        self._slot_req: List[Optional[Request]] = [None] * S
        self._slot_tokens: List[List[int]] = [[] for _ in range(S)]
        self._prefilling: Dict[int, _Prefill] = {}
        self._decoding: set = set()
        # per-slot state on the model's device, updated in place by every
        # step; block tables stay host-side numpy and ride into each call.
        # Under a mesh they are replicated: held once in driver mode, a
        # full copy on every process over a multiproc mesh.
        dev = model_device(model)
        self._dev_lengths = torch.zeros((S,), dtype=torch.int32, device=dev)
        self._dev_tokens = torch.zeros((S,), dtype=torch.int32, device=dev)
        self._dev_rngs = torch.zeros((S, 2), dtype=torch.int64, device=dev)
        self.completions: Dict[str, Completion] = {}
        # pre-warm: run the table's program calls once now, leaving this
        # engine's pool, lanes and bookkeeping as they are
        self.prewarm_timings: Dict = {}
        if precompiled:
            from .prewarm import warm_engine

            self.prewarm_timings = warm_engine(self, precompiled)

    # -- admission ---------------------------------------------------------
    def submit(
        self,
        prompt,
        max_new_tokens: int,
        rid: Optional[str] = None,
        seed: int = 0,
        arrival_time: Optional[float] = None,
        tenant: str = "",
        klass: str = DEFAULT_CLASS,
    ) -> str:
        """Enqueue one generation request; returns its request id.
        Raises `QueueFullError` (counted in metrics as a shed) when
        bounded admission is on and the request's class is the worst
        present; a HIGHER-class submit into a full queue instead
        displaces the newest worst-class queued request (recorded in
        `shed_requests` + per-class metrics) and succeeds.

        `arrival_time` (engine-clock seconds) is trace-replay support:
        a single-threaded replay driver can only call submit() between
        steps, so stamping the clock would erase the queueing delay a
        request already served before the driver got to it — pass the
        TRUE front-door arrival and TTFT/e2e account for it (the static
        baseline in serve_bench measures from trace arrival too)."""
        req = Request(
            prompt=np.asarray(prompt, np.int32).reshape(-1),
            max_new_tokens=max_new_tokens,
            rid=rid or "",
            seed=seed,
            tenant=tenant,
            klass=klass,
        )
        L = len(req.prompt)
        if L < 1:
            raise ValueError("empty prompt")
        if L + max_new_tokens > self.cfg.max_seq_len:
            raise ValueError(
                f"prompt ({L}) + max_new_tokens ({max_new_tokens}) exceeds "
                f"max_seq_len ({self.cfg.max_seq_len})"
            )
        bucket_for(L, self.buckets)  # raises when no bucket fits
        worst = self.cache.blocks_for(L + max_new_tokens)
        if worst > self.cache.num_blocks:
            raise ValueError(
                f"request needs up to {worst} blocks but the pool has "
                f"{self.cache.num_blocks} (grow pool_blocks or shrink "
                f"the request)"
            )
        req.arrival_time = (
            self.clock() if arrival_time is None else arrival_time
        )
        try:
            victim = self.queue.put(req)
        except QueueFullError:
            self.metrics.record_shed(req.klass)
            raise
        if victim is not None:
            # class-ordered overload shed: a queued worse-class request
            # made room for this one (it never ran; callers see it in
            # shed_requests, metrics count it against ITS class)
            self.shed_requests[victim.rid] = victim
            while len(self.shed_requests) > self._max_shed_kept:
                self.shed_requests.pop(next(iter(self.shed_requests)))
            self.metrics.record_shed(victim.klass)
        self.metrics.record_submit(req.arrival_time, req.klass)
        return req.rid

    def _chunk_len(self, L: int) -> int:
        """Upper bound on the first prefill program length for a prompt
        of length L: the per-step token budget when chunking is on,
        else the prompt's bucket (unchunked, per-bucket programs). The
        admission gate sizes its first-chunk block estimate from this."""
        if self.prefill_chunk_tokens is not None:
            return self.prefill_chunk_tokens
        return bucket_for(L, self.buckets)

    def _admit(self) -> int:
        if self.role == "decode":
            # decode-pool engines admit ONLY via attach_migrated;
            # anything queued here is a preempted migrant waiting for
            # the disagg router to route it back through a prefill
            # engine (replay-from-seed)
            return 0
        return self._admit_queue()

    def _admit_queue(self) -> int:
        """Backfill free slots from the queue (continuous batching:
        called at the top of every step, so retirement and admission
        interleave mid-stream). The queue's weighted round-robin picks
        the candidate; when that candidate cannot acquire resources,
        strictly-HIGHER-priority class heads also get a try (they may
        preempt a worse class's in-flight work — `_class_preempt_for`),
        so overload never wedges the high class behind a low-class head
        that cannot make progress. Admission stops when no candidate
        can acquire a slot + first-chunk blocks — the allocate-on-write
        backpressure gate. Returns the number admitted this round."""
        admitted = 0
        while True:
            candidates = self._admission_candidates()
            if not candidates:
                return admitted
            progressed = False
            for head in candidates:
                outcome = self._try_admit(head)
                if outcome == "admitted":
                    admitted += 1
                    progressed = True
                    break
                if outcome == "stop":
                    return admitted
                # "blocked": this candidate cannot acquire resources —
                # a better class may still preempt its way in
            if not progressed:
                return admitted

    def _admission_candidates(self) -> List[Request]:
        """The SWRR-selected head first, then heads of STRICTLY better
        priority classes, best-first (single-class queues: just the
        head). Worse classes never bypass a blocked candidate — they
        could only squeeze into space the blocked class will preempt
        right back, churning admissions without progress."""
        heads = self.queue.class_heads()
        if not heads:
            return []
        sel = self.queue.peek()
        if sel is None or not self.classes:
            return [sel] if sel is not None else []
        sp = self.classes[sel.klass].priority
        rest = sorted(
            (
                r
                for r in heads.values()
                if r is not sel and self.classes[r.klass].priority < sp
            ),
            key=lambda r: self.classes[r.klass].priority,
        )
        return [sel] + rest

    def _try_admit(self, head: Request) -> str:
        """Acquire slot + first-chunk blocks for `head` (class-preempting
        worse in-flight work while allowed) and admit it. Returns
        "admitted", "blocked" (resources unavailable for THIS candidate),
        or "stop" (end the whole admission round).

        ALL gates precheck — before anyone is evicted — that evicting
        the available worse-class victims could satisfy them JOINTLY
        (eviction frees a victim's slot, blocks, and reservation at
        once, so each gate's feasibility at the evict-everything bound
        is monotone and the per-gate prechecks compose). A candidate
        that would stay blocked after evicting every victim must not
        evict at all — otherwise each admission round would pointlessly
        kill worse-class work (possibly work admitted moments earlier),
        churning requeues without any gold progress."""
        head_len = len(head.prompt)
        # first-chunk sizing ignores a possible prefix-cache hit (the
        # match runs after the fire points, post-acquisition): a hit
        # only ever needs FEWER fresh blocks, so the gate errs toward
        # backpressure, never toward overcommit
        need = self.cache.blocks_for(min(self._chunk_len(head_len), head_len))
        victims = self._class_victims(head)
        if need > self.cache.free_blocks + sum(
            # only a victim's EXCLUSIVE blocks are guaranteed back —
            # shared prefix blocks outlive the eviction
            self.cache.exclusive_blocks(s) for s in victims
        ):
            return "blocked"  # pool backpressure: wait for retires
        if self.conservative_admission:
            worst = self.cache.blocks_for(head_len + head.max_new_tokens)
            releasable = sum(
                self._worst_blocks(self._slot_req[s]) for s in victims
            )
            if self._reserved - releasable + worst > self.cache.num_blocks:
                return "blocked"  # worst-case reservation gate
        if (
            len(self.cache.active_slots) >= self.cache.slots
            and not victims
        ):
            return "blocked"  # slot pressure with nothing evictable
        # feasible: now acquire, evicting as needed
        while need > self.cache.free_blocks:
            if not self._class_preempt_for(head):
                return "blocked"
        if self.conservative_admission:
            while self._reserved + worst > self.cache.num_blocks:
                if not self._class_preempt_for(head):
                    return "blocked"
        slot = self.cache.allocate()
        while slot is None:
            if not self._class_preempt_for(head):
                return "blocked"
            slot = self.cache.allocate()
        if not self.queue.pop_specific(head):
            # racing submitter drained it between checks
            self.cache.free(slot)
            return "stop"
        req = head
        try:
            faults.fire("serve.admit", rid=req.rid)
        except _TRANSIENT:
            # transient admission fault: the request goes back to the
            # HEAD (arrival order preserved) and this round stops —
            # the next step() retries
            self.cache.free(slot)
            req.requeues += 1
            self.queue.requeue_front(req)
            self.metrics.record_requeue()
            return "stop"
        pos0 = 0
        if self.prefix is not None:
            try:
                faults.fire("serve.prefix_attach", rid=req.rid)
            except _TRANSIENT:
                # transient attach fault: nothing was attached yet (the
                # slot holds zero blocks), so freeing it is clean; the
                # replay re-matches the index and attaches the SAME
                # shared blocks deterministically
                self.cache.free(slot)
                req.requeues += 1
                self.queue.requeue_front(req)
                self.metrics.record_requeue()
                return "stop"
            # hit/miss/reuse accounting lives in the INDEX (the next
            # record_pool snapshots its stats() into the metrics)
            blocks, matched = self.prefix.match(
                self._prefix_scope(req), req.prompt.tolist()
            )
            if matched > 0:
                self.cache.attach_prefix(slot, blocks)
                pos0 = matched
        self._slot_req[slot] = req
        self._slot_tokens[slot] = []
        self._prefilling[slot] = _Prefill(req, pos=pos0)
        self._reserved += self._worst_blocks(req)
        self.metrics.record_admit()
        return "admitted"

    def _prefix_scope(self, req: Request):
        """The sharing boundary for `req`'s prefix-cache entries —
        `serve.prefix.prefix_scope`, the one definition shared with the
        DP router's session affinity."""
        from .prefix import prefix_scope

        return prefix_scope(self.classes, req.klass, req.tenant)

    def _class_victims(self, head: Request) -> List[int]:
        """Slots holding in-flight work of a class STRICTLY below
        `head`'s priority — what cross-class preemption may evict
        (equal-or-better classes never; same-class pressure stays
        ordinary backpressure)."""
        if not self.class_preemption:
            return []
        hp = self.classes[head.klass].priority
        return [
            s
            for s in range(self.cache.slots)
            if self._slot_req[s] is not None
            and self.classes[self._slot_req[s].klass].priority > hp
        ]

    def _class_preempt_for(self, head: Request) -> bool:
        """Cross-class preemption: evict the youngest in-flight request
        of the WORST class strictly below `head`'s priority; the evictee
        requeues at its class head and replays token-identically from
        its seed. False when no victim exists."""
        victims = self._class_victims(head)
        if not victims:
            return False
        victim = max(
            victims,
            key=lambda s: (
                self.classes[self._slot_req[s].klass].priority,
                self._slot_req[s].arrival_time,
            ),
        )
        klass = self._slot_req[victim].klass
        self._evict(victim, requeue_counter=False)
        self.metrics.record_class_preempt(klass)
        return True

    def _worst_blocks(self, req: Request) -> int:
        """A request's worst-case block footprint (prompt + full token
        budget) — the conservative-admission reservation unit."""
        return self.cache.blocks_for(len(req.prompt) + req.max_new_tokens)

    # -- chunked prefill ---------------------------------------------------
    def _prefill_tick(self) -> None:
        """Advance prefills. Unchunked: run EVERY pending prefill to
        completion (one bucketed program each). Chunked: spend a per-step
        TOKEN BUDGET of `prefill_chunk_tokens` program tokens, shortest-remaining-
        prefill first — short prompts SHARE one step's budget (a
        32-token budget prefills two 16-token prompts in the same step)
        while a long prompt advances one budget-sized chunk per step,
        interleaved with decode. A short arrival therefore never waits
        behind a whole long prefill (the bounded-TTFT policy), and the
        prefill service rate is budget/step rather than one program per
        step. At least one program runs per tick, so a budget below the
        smallest bucket still makes progress."""
        budget = self.prefill_chunk_tokens
        spent = 0
        while self._prefilling:
            # class priority outranks shortest-remaining: a gold prompt's
            # chunks never queue behind bronze prefill work (single-class
            # engines: pure shortest-remaining-first)
            slot = min(
                self._prefilling,
                key=lambda s: (
                    self.classes[self._prefilling[s].req.klass].priority
                    if self.classes
                    else 0,
                    len(self._prefilling[s].req.prompt)
                    - self._prefilling[s].pos,
                    self._prefilling[s].req.arrival_time,
                ),
            )
            pf = self._prefilling[slot]
            req = pf.req
            L = len(req.prompt)
            if budget is None:
                # bucket over the REMAINING prompt: a prefix-cache
                # attach starts the (single, unchunked) program at the
                # first uncached position, not at 0
                C = bucket_for(L - pf.pos, self.buckets)
            else:
                # program length this tick: the bucket covering what the
                # remaining budget can spend, capped at the budget (so
                # the chunk shapes stay a bounded set: buckets
                # <= budget, plus the budget itself)
                want = max(1, min(L - pf.pos, budget - spent))
                C = min(bucket_for(want, self.buckets), budget)
                if spent and spent + C > budget:
                    return  # budget spent: yield to decode
            end = min(pf.pos + C, L)
            if not self._ensure_or_preempt(slot, end - 1):
                continue  # the prefilling request itself got evicted
            if not self._cow_or_preempt(slot, pf.pos):
                continue  # ditto, while claiming a copy-on-write block
            try:
                faults.fire("serve.prefill_chunk", rid=req.rid, pos=pf.pos)
            except _TRANSIENT:
                self._evict(slot, requeue_counter=True)
                continue
            chunk = np.zeros((1, C), np.int32)
            chunk[0, : end - pf.pos] = req.prompt[pf.pos:end]
            self.cache.tree, logits = self._prefill_chunk(
                self.cache.tree,
                chunk,
                self.cache.block_tables[slot : slot + 1],
                pf.pos,
            )
            start = pf.pos
            pf.pos = end
            spent += C
            if end < L:
                if budget is not None and spent >= budget:
                    return  # budget spent: yield to decode
                continue
            # final chunk: sample the first token at the TRUE prompt end
            # and set the request's lanes in the slot vectors
            first_dev, key = self._first_token(
                logits, (L - 1) - start, req.seed
            )
            first = int(first_dev)
            (
                self._dev_lengths,
                self._dev_tokens,
                self._dev_rngs,
            ) = self._attach(
                self._dev_lengths,
                self._dev_tokens,
                self._dev_rngs,
                slot,
                L,
                first_dev,
                key,
            )
            self.cache.lengths[slot] = L  # host mirror for introspection
            if self.prefix is not None:
                # index the prompt's blocks NOW, before the first decode
                # write lands — entries hold PROMPT K/V only, so decoded
                # tokens can never be served to another request (the
                # slot's own next write into its partial tail block
                # copy-on-writes it, leaving the indexed original
                # pristine)
                self.prefix.insert(
                    self._prefix_scope(req), req.prompt.tolist(),
                    self.cache.slot_blocks(slot),
                )
            del self._prefilling[slot]
            self._slot_tokens[slot] = [first]
            now = self.clock()
            req.first_token_time = now
            self._note_recovery(now)
            done = (
                "eos"
                if self.eos_id is not None and first == self.eos_id
                else "length"
                if req.max_new_tokens == 1
                else None
            )
            if done is not None:
                # single-token completions finish here regardless of
                # role: there is nothing left to decode, so migrating
                # would move blocks only to free them
                self._decoding.add(slot)
                self._retire(slot, now, done)
            elif self.role == "prefill":
                # freeze for migration: the slot keeps its request and
                # blocks (the migration plane exports them), the lane
                # stays parked. TTFT is done (the first token exists),
                # so it lands in this pool's window now; completion and
                # TPOT land in the decode pool's.
                self._handoff.append(
                    Handoff(req=req, slot=slot, length=L, first=first)
                )
                self.metrics.record_first_token(
                    now, now - req.arrival_time, klass=req.klass
                )
            else:
                self._decoding.add(slot)
            if budget is not None and spent >= budget:
                return  # budget spent: yield to decode

    # -- pool pressure -----------------------------------------------------
    def _preempt_for_pool(self, slot: int) -> bool:
        """ONE pool-pressure eviction: the WORST-CLASS then youngest
        active request loses its slot and blocks (single-class engines:
        plain youngest-first). Returns False when the
        victim was `slot` itself — the caller's own request got evicted
        and its retry loop must stop. The ONE copy of the pressure
        policy: block growth and copy-on-write both retry through it,
        so they can never diverge."""
        victims = [
            s
            for s in range(self.cache.slots)
            if self._slot_req[s] is not None
        ]
        victim = max(
            victims,
            key=lambda s: (
                self.classes[self._slot_req[s].klass].priority
                if self.classes
                else 0,
                self._slot_req[s].arrival_time,
            ),
        )
        klass = self._slot_req[victim].klass
        self._evict(victim, requeue_counter=False)
        self.metrics.record_preempt(klass=klass)
        return victim != slot

    def _ensure_or_preempt(self, slot: int, upto_pos: int) -> bool:
        """Grow `slot`'s block table to cover `upto_pos`, evicting via
        `_preempt_for_pool` while the pool is dry. Returns False when
        the grower itself got evicted. Deadlock-free: submit()
        guarantees any single request's worst case fits the pool, so
        the oldest request of the best class always wins."""
        while not self.cache.ensure_blocks(slot, upto_pos):
            if not self._preempt_for_pool(slot):
                return False
        return True

    def _cow_or_preempt(self, slot: int, pos: int) -> bool:
        """Copy-on-write the block a write at `pos` would land in while
        it is shared or index-pinned, evicting via `_preempt_for_pool`
        while the pool cannot spare the copy's block. Returns False
        when the writer itself got evicted. Almost always a no-op: only
        the FIRST write past a shared partial boundary (or into the
        slot's own freshly indexed tail) copies; the copy is private
        from then on."""
        while not self.cache.cow_block(slot, pos):
            if not self._preempt_for_pool(slot):
                return False
        return True

    def _evict(self, slot: int, requeue_counter: bool) -> None:
        """Push a slot's request back to the queue HEAD and free the
        slot + its blocks (preemption and transient-chunk-fault path).
        The replay is token-identical — per-request seeds."""
        req = self._slot_req[slot]
        req.requeues += 1
        req.first_token_time = None
        self._slot_req[slot] = None
        self._slot_tokens[slot] = []
        self._prefilling.pop(slot, None)
        self._decoding.discard(slot)
        # an evicted FROZEN handoff replays through prefill again: its
        # record must go, or the migration plane would export a freed
        # (possibly reallocated) slot's blocks
        self._handoff = [h for h in self._handoff if h.slot != slot]
        self.queue.requeue_front(req)
        self.cache.free(slot)
        self._reserved -= self._worst_blocks(req)
        if requeue_counter:
            self.metrics.record_requeue()

    # -- decode ------------------------------------------------------------
    @numerics_contract(
        "token_exact",
        note="a greedy request's emitted token stream is identical "
        "across preemptions, drains and cache-sharing on/off "
        "(per-request seeds make replay exact); on the card at fixed "
        "program shapes, since cuBLAS picks its algorithm by shape",
    )
    def step(self) -> bool:
        """One engine iteration: admit, advance prefills (one chunk when
        chunking is on), grow/preempt blocks, advance every decoding
        slot one token, retire finished requests. Returns True while
        work remains (active slots, prefills, or queued requests)."""
        self._admit()
        self.metrics.record_step(
            self.queue.depth,
            len(self.cache.active_slots),
            class_depths=(
                self.queue.class_depths() if self.classes else None
            ),
        )
        self.metrics.record_pool(
            self.cache.live_blocks,
            self.cache.num_blocks,
            self.cache.bytes_per_block,
            len(self._decoding) + len(self._prefilling),
            self.cache.dense_bytes_per_request,
            wire_dtype=self.cache.wire_dtype,
            scale_bytes_per_block=self.cache.scale_bytes_per_block,
            effective_slots=self.cache.effective_slots,
            shared_blocks=self.cache.shared_blocks,
            cached_free_blocks=self.cache.cached_free_blocks,
            cow_copies=self.cache.cow_copies,
            bytes_deduplicated=self.cache.bytes_deduplicated,
            prefix_stats=self.prefix.stats() if self.prefix else None,
        )
        while True:
            self._prefill_tick()
            # a prefill-finish retire (eos / budget 1) frees a slot
            # MID-STEP; unchunked backfills and prefills it in the same
            # iteration. Chunked mode
            # still grants the slot (next step's tick prefills it) but
            # spends no further chunk budget.
            if self._admit() == 0 or self.prefill_chunk_tokens is not None:
                break
        if not self._decoding:
            return bool(self._prefilling) or bool(self.queue)
        try:
            faults.fire("serve.step", n_active=len(self._decoding))
        except _TRANSIENT:
            self.requeue_inflight()
            return True
        # allocate-on-write: every decoding slot must own the block its
        # next token lands in BEFORE the batched write (preemption may
        # shrink the decoding set here)
        for s in sorted(self._decoding):
            if s not in self._decoding:  # evicted by an earlier growth
                continue
            if not self._ensure_or_preempt(s, int(self.cache.lengths[s])):
                continue
            # first decode write past a shared/indexed prefix boundary
            # must own a private copy of that block (CoW)
            self._cow_or_preempt(s, int(self.cache.lengths[s]))
        active = sorted(self._decoding)
        if not active:
            return bool(self._prefilling) or bool(self.queue)
        # a mid-prefill slot's lane is parked but its table row already
        # holds real blocks (chunks land as they arrive): hand the step a
        # copy with those rows invalidated, so the parked lane's write
        # goes to the sink instead of the request's own block 0. Frozen
        # handoff slots are the same hazard with higher stakes: their
        # blocks are the migration payload. Retired rows are already
        # all-invalid via free().
        bt = self.cache.block_tables
        frozen = sorted(self._prefilling) + sorted(h.slot for h in self._handoff)
        if frozen:
            bt = bt.copy()
            bt[frozen] = self.cache.invalid_block
        (
            self.cache.tree,
            self._dev_lengths,
            nxt,
            self._dev_rngs,
        ) = self._step(
            self.cache.tree,
            self._dev_lengths,
            self._dev_tokens,
            self._dev_rngs,
            bt,
        )
        self._dev_tokens = nxt
        nxt_h = nxt.cpu().numpy()  # the hot path's one host readback
        now = self.clock()
        for s in active:
            req = self._slot_req[s]
            tok = int(nxt_h[s])
            self._slot_tokens[s].append(tok)
            self.cache.lengths[s] += 1
            if self.eos_id is not None and tok == self.eos_id:
                self._retire(s, now, "eos")
            elif len(self._slot_tokens[s]) >= req.max_new_tokens:
                self._retire(s, now, "length")
        return (
            bool(self._decoding)
            or bool(self._prefilling)
            or bool(self.queue)
        )

    def run(self, max_steps: Optional[int] = None) -> Dict[str, Completion]:
        """Drive step() until the queue and slots drain (or max_steps);
        returns the completion map."""
        n = 0
        while self.step():
            n += 1
            if max_steps is not None and n >= max_steps:
                raise DistError(
                    f"serve engine did not drain within {max_steps} steps "
                    f"(active={len(self.cache.active_slots)}, "
                    f"queued={self.queue.depth})"
                )
        return self.completions

    # -- retirement / fault recovery ---------------------------------------
    def _retire(self, slot: int, now: float, reason: str) -> None:
        req = self._slot_req[slot]
        toks = self._slot_tokens[slot]
        n = len(toks)
        tpot = (
            (now - req.first_token_time) / (n - 1) if n > 1 else 0.0
        )
        comp = Completion(
            rid=req.rid,
            tokens=list(toks),
            prompt_len=len(req.prompt),
            finish_reason=reason,
            ttft_s=req.first_token_time - req.arrival_time,
            tpot_s=tpot,
            e2e_s=now - req.arrival_time,
            requeues=req.requeues,
            tenant=req.tenant,
            klass=req.klass,
        )
        self.completions[req.rid] = comp
        self.metrics.record_complete(
            now, n, comp.ttft_s, tpot, comp.e2e_s, klass=req.klass
        )
        self._slot_req[slot] = None
        self._slot_tokens[slot] = []
        self._decoding.discard(slot)
        self.cache.free(slot)  # slot AND its blocks return to the pool
        self._reserved -= self._worst_blocks(req)

    def snapshot_state(self) -> Dict:
        """Non-destructive restartable snapshot at a step boundary —
        the PERIODIC checkpointing path (crash consistency while the
        engine keeps serving; a kill between checkpoints only costs the
        replay of work the last snapshot already covers).

        JSON-able payload: every unfinished request's full metadata
        (prompt, seed, token budget, tenant/class, arrival, requeue
        count) — in-flight requests first in arrival order, exactly the
        order `requeue_inflight` would restore — plus the in-flight
        emitted-token ledger (the tokens a restart throws away and
        replays) and the checkpoint timestamp anchoring the
        recovery-time metric.

        `serve.drain` fires BEFORE any state is read: a transient
        injected fault aborts the snapshot with the engine untouched."""
        faults.fire(
            "serve.drain",
            queued=self.queue.depth,
            active=self.num_active,
        )
        inflight = sorted(
            (
                self._slot_req[s]
                for s in range(self.cache.slots)
                if self._slot_req[s] is not None
            ),
            key=lambda r: r.arrival_time,
        )
        emitted = {
            self._slot_req[s].rid: len(self._slot_tokens[s])
            for s in range(self.cache.slots)
            if self._slot_req[s] is not None
        }
        heads, tails = self.queue.snapshot_split()
        return {
            "version": 1,
            "checkpoint_time": float(self.clock()),
            "emitted": emitted,
            # "requests": engine-accepted work (in-flight + requeued) —
            # restored exempt from bounds; "queued": the submitted-tail
            # backlog — restored into the bounded, class-sheddable tails
            "requests": [r.to_state() for r in inflight + heads],
            "queued": [r.to_state() for r in tails],
        }

    def drain(self) -> Dict:
        """Stop serving at a step boundary and capture restartable
        state — the elastic-agent restart/resize path.

        `snapshot_state()` plus the terminal half: quiesce the device
        lanes through the `serve/decode.py` drain seam (the device has
        finished every queued write, the pool's included) and requeue all in-flight work (each
        request replays token-identically from its seed, so dropping
        device state loses nothing but the replay time). The engine
        itself stays usable — a cancelled drain just keeps serving."""
        state = self.snapshot_state()
        (
            self._dev_lengths,
            self._dev_tokens,
            self._dev_rngs,
        ) = sync_slot_lanes(
            self._dev_lengths, self._dev_tokens, self._dev_rngs
        )
        self.requeue_inflight()
        return state

    def _note_recovery(self, now: float) -> None:
        """First emitted token after an elastic restore closes the
        recovery window (drain timestamp -> token served on the
        re-formed gang)."""
        if self._recovery_anchor is None:
            return
        restored, replayed, gen = self._recovery_meta
        self.metrics.record_recovery(
            now - self._recovery_anchor, restored, replayed, gen
        )
        self._recovery_anchor = None

    def requeue_inflight(self) -> int:
        """Drain every in-flight request (decoding AND mid-prefill) back
        to the queue HEAD in ARRIVAL order and free slots + blocks — the
        mid-stream kill/restart path. Each request replays from scratch
        off its own seed, so greedy outputs are unchanged by any number
        of requeues."""
        inflight = sorted(
            (
                s
                for s in range(self.cache.slots)
                if self._slot_req[s] is not None
            ),
            key=lambda s: self._slot_req[s].arrival_time,
        )
        for s in reversed(inflight):
            req = self._slot_req[s]
            req.requeues += 1
            req.first_token_time = None
            self._slot_req[s] = None
            self._slot_tokens[s] = []
            self._prefilling.pop(s, None)
            self._decoding.discard(s)
            self.queue.requeue_front(req)
            self.cache.free(s)
            self._reserved -= self._worst_blocks(req)
        # frozen handoffs were in flight too (their slots held requests),
        # requeued above; drop the stale migration records
        self._handoff = []
        self.metrics.record_requeue(len(inflight))
        return len(inflight)

    # -- disaggregated handoff / landing (serve/disagg/) -------------------
    def pop_handoffs(self) -> List[Handoff]:
        """Drain the frozen-handoff list (``role="prefill"``). The slots
        stay frozen (blocks pinned, lanes parked) until the caller
        exports each payload and calls `release_handoff`; a step between
        pop and release is safe (frozen rows are invalidated in `step`),
        but an eviction in that window makes the record stale, which
        `release_handoff` detects by request identity."""
        out, self._handoff = self._handoff, []
        return out

    def release_handoff(self, h: Handoff) -> None:
        """Return a migrated handoff's slot and blocks to the pool, after
        the payload is durably published (a crash between publish and
        release just re-sends identical bytes). A no-op when the slot no
        longer holds `h.req` (evicted since the pop: the request is
        replaying anyway)."""
        if self._slot_req[h.slot] is not h.req:
            return
        self._slot_req[h.slot] = None
        self._slot_tokens[h.slot] = []
        self.cache.free(h.slot)
        self._reserved -= self._worst_blocks(h.req)

    def attach_migrated(self, req: Request, length: int, first: int,
                        payload) -> Optional[int]:
        """Land a migrated prefill on this (decode-pool) engine: claim a
        slot, import the KV block payload (`PagedKVCache.import_blocks`:
        raw, int8 and scale planes included, so the landed blocks are bit
        for bit the prefill pool's), and seed the slot's lanes with the
        already-sampled first token and the carry key rebuilt from
        `req.seed` (`serve/decode.py::carry_key`). Decode then proceeds
        as if this engine had prefilled locally. Returns the slot, or
        None when this engine cannot hold the request now (nothing was
        mutated; the caller retries or picks another replica)."""
        from .decode import carry_key

        if self.role == "prefill":
            raise DistError("prefill-pool engines cannot land migrations")
        worst = self._worst_blocks(req)
        if self.conservative_admission and (
            self._reserved + worst > self.cache.num_blocks
        ):
            return None
        slot = self.cache.allocate()
        if slot is None:
            return None
        if not self.cache.ensure_blocks(slot, length - 1):
            self.cache.free(slot)
            return None
        self.cache.import_blocks(self.cache.slot_blocks(slot), payload)
        dev = model_device(self.model)
        (
            self._dev_lengths,
            self._dev_tokens,
            self._dev_rngs,
        ) = self._attach(
            self._dev_lengths,
            self._dev_tokens,
            self._dev_rngs,
            slot,
            length,
            torch.tensor(first, dtype=torch.int32, device=dev),
            carry_key(req.seed, dev),
        )
        self.cache.lengths[slot] = length
        self._slot_req[slot] = req
        self._slot_tokens[slot] = [first]
        self._decoding.add(slot)
        self._reserved += worst
        self.metrics.record_admit()
        if req.first_token_time is None:
            # the migration's manifest normally carries the prefill-side
            # stamp; fall back to now so TPOT stays finite either way
            req.first_token_time = self.clock()
        self._note_recovery(self.clock())
        return slot

    # -- introspection -----------------------------------------------------
    @property
    def num_active(self) -> int:
        return len(self.cache.active_slots)

    @property
    def pending(self) -> int:
        return self.queue.depth + self.num_active
