"""KV cache memory managers for the serve engine, the port of the
reference's `serve/cache.py`.

* `PagedKVCache` — the engine's cache: a pool of ``(num_blocks,
  block_size, kv_heads, head_dim)`` K/V blocks per layer plus a host-side
  per-slot block table mapping logical blocks to physical ones. Blocks are
  allocated on write and freed at retire, so cache memory tracks live
  tokens. Entries equal to ``num_blocks`` mark unallocated logical blocks.
  Physical blocks are refcounted for prefix sharing (`attach_prefix`,
  `serve/prefix.py`), written copy-on-write (`cow_block`), and blocks
  whose refcount drops to 0 while a prefix index names them wait on a
  cached free list, reclaimed LRU after the plain free list.
  ``quantized=True`` stores K/V as int8 with per-(token, kv-head) float32
  scale planes (`ops/quant.py`).

* `SlotKVCache` — the dense per-slot layout: one ``(slots, max_seq_len,
  kv_heads, head_dim)`` buffer per layer, whole-buffer prefill-into-slot.

The sink. Every pool tensor holds ``num_blocks + 1`` blocks; the last is a
sink that is never allocated and never counted (`free_blocks`,
`bytes_per_block`, `pool_utilization` are the reference's numbers). The
reference's paged write is a `mode="drop"` scatter, which discards writes
through an unallocated entry or past the table; torch has no such scatter,
so the paged path (`models/transformer.py`) sends those writes to the sink
and its gather reads the sink for unallocated entries, under the causal
mask. Parked lanes and padded chunks stay harmless that way, with no host
sync and no out-of-range index.

The pool tensors are updated in place (the reference donates them through
its programs); the tables, refcounts and free lists live on the host.

Under a tensor-parallel engine the pool's leaves are `DTensor`s over the
``tp`` mesh (`parallel.tensor_parallel.shard_kv_pool`): rank-leading
(T, num_blocks + 1, block_size, kv_heads / T, ...) stacks, their block
axis dim 1. The bookkeeping is the same; copy-on-write copies a block in
every rank's shard, and `export_blocks` / `import_blocks` give and take
the global (kv_heads-wide) layout, the same bytes whatever T is, so a
migration may land on a pool of another TP degree.
"""

from __future__ import annotations

import functools
from collections import OrderedDict
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from ..dtensor import DTensor, distribute_tensor
from ..models.generate import init_cache, model_device

__all__ = ["SlotKVCache", "PagedKVCache", "init_paged_cache", "land_slot"]


def _leaves(tree):
    for node in tree.values():
        yield from node["attn"].values()


def _blocks(buf):
    """A pool leaf indexable by block id along dim 0: the tensor itself,
    or a `DTensor`'s stacked locals with the rank dim behind the block
    axis (a view, so writes land in every rank's shard)."""
    return buf._local.transpose(0, 1) if isinstance(buf, DTensor) else buf


def _export_leaf(buf, idx):
    """Blocks `idx` of one pool leaf in the global layout, on the host."""
    if isinstance(buf, DTensor):
        part = DTensor(buf._local.index_select(1, idx), buf.device_mesh, buf.placements)
        return part.full_tensor().cpu()
    return buf.index_select(0, idx).cpu()


def _import_leaf(buf, idx, part):
    """Write `part` (blocks in the global layout) onto blocks `idx` of one
    pool leaf, verbatim: a dtype that is not the pool's raises."""
    part = torch.as_tensor(part)
    if part.dtype != buf.dtype:
        raise TypeError(f"migration payload of {part.dtype} for a pool of {buf.dtype}")
    part = part.to(idx.device)
    if isinstance(buf, DTensor):
        buf._local.index_copy_(1, idx, distribute_tensor(part, buf.device_mesh,
                                                         buf.placements)._local)
    else:
        buf.index_copy_(0, idx, part)


def land_slot(tree, pre, slot: int):
    """Write a B=1 cache tree `pre` into slot `slot` of the slot tree (a
    full-buffer overwrite), in place; the scalar `index` leaves pass
    through (per-slot lengths live with the caller)."""
    for layer, node in tree.items():
        for name, buf in node["attn"].items():
            if buf.dim() == 0:
                continue
            s = min(max(slot, 0), buf.shape[0] - 1)  # XLA's clamped start
            buf[s:s + 1].copy_(pre[layer]["attn"][name])
    return tree


def _itemsize(dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def _dtype_name(dtype) -> str:
    return str(dtype).removeprefix("torch.")


class SlotKVCache:
    """Slot-managed dense KV cache over `model`'s decode path.

    `tree` is the live cache tree ((slots, M, KV, Dh) K/V per layer);
    `lengths` is the host-side per-slot position vector (also the position
    the next token is written at). Free slots keep length 0."""

    def __init__(self, model, slots: int):
        if slots < 1:
            raise ValueError(f"slots must be >= 1, got {slots}")
        self.model = model
        self.slots = slots
        self.tree = init_cache(model, slots)
        self.lengths = np.zeros((slots,), np.int32)
        self._in_use = np.zeros((slots,), bool)
        self._free: List[int] = list(range(slots))

    def allocate(self) -> Optional[int]:
        """A free slot index, or None when the cache is full."""
        if not self._free:
            return None
        s = self._free.pop(0)
        self._in_use[s] = True
        return s

    def free(self, slot: int) -> None:
        if not self._in_use[slot]:
            raise ValueError(f"slot {slot} is not allocated")
        self._in_use[slot] = False
        self.lengths[slot] = 0
        self._free.append(slot)

    def reset(self) -> None:
        """Free every slot. The buffers are not cleared: a prefill
        overwrites a slot's whole buffer before reuse."""
        self._in_use[:] = False
        self.lengths[:] = 0
        self._free = list(range(self.slots))

    def write_prefill(self, slot: int, prefill_tree, length: int) -> None:
        """Land a B=1 prefill cache into `slot` and set its length."""
        if not self._in_use[slot]:
            raise ValueError(f"slot {slot} is not allocated")
        if not 0 < length <= self.model.cfg.max_seq_len:
            raise ValueError(f"prefill length {length} outside (0, "
                             f"{self.model.cfg.max_seq_len}]")
        land_slot(self.tree, prefill_tree, slot)
        self.lengths[slot] = length

    @property
    def active_slots(self) -> List[int]:
        return [s for s in range(self.slots) if self._in_use[s]]

    @property
    def occupancy(self) -> float:
        return float(self._in_use.sum()) / self.slots

    def __repr__(self) -> str:
        return (f"SlotKVCache(slots={self.slots}, active={int(self._in_use.sum())}, "
                f"lengths={self.lengths.tolist()})")


def init_paged_cache(model, num_blocks: int, block_size: int, quantized: bool = False):
    """An empty paged pool for `model` on its device: per layer K and V of
    (num_blocks + 1, block_size, kv_heads, head_dim), the last block the
    sink, in `cfg.dtype`; `quantized=True` makes them int8 beside float32
    `k_scale`/`v_scale` planes of (num_blocks + 1, block_size, kv_heads).
    The tree is the reference's minus the scalar index (a shared pool has
    no per-row cursor)."""
    cfg = model.cfg
    dev = model_device(model)
    shape = (num_blocks + 1, block_size, cfg.kv_heads, cfg.head_dim)

    def one_layer():
        if quantized:
            return {"attn": {
                "k": torch.zeros(shape, dtype=torch.int8, device=dev),
                "v": torch.zeros(shape, dtype=torch.int8, device=dev),
                "k_scale": torch.zeros(shape[:3], dtype=torch.float32, device=dev),
                "v_scale": torch.zeros(shape[:3], dtype=torch.float32, device=dev),
            }}
        return {"attn": {"k": torch.zeros(shape, dtype=cfg.dtype, device=dev),
                         "v": torch.zeros(shape, dtype=cfg.dtype, device=dev)}}

    return {f"layers_{i}": one_layer() for i in range(cfg.n_layers)}


class PagedKVCache:
    """Block-pool KV cache: slot bookkeeping and allocate-on-write blocks.

    `tree` is the live pool tree (see `init_paged_cache`); `block_tables`
    is the host (slots, nb) int32 table the programs take on each call
    (entries == num_blocks mark unallocated logical blocks); `lengths`
    mirrors per-slot depth for introspection. Blocks return to the free
    list at `free()` in FIFO reuse order.

    Every physical block carries a refcount. `ensure_blocks` hands out
    refcount-1 blocks, `attach_prefix` adopts already-filled blocks,
    `free()` decrements. A slot about to write into a block that is shared
    or pinned by a prefix-index entry calls `cow_block` first: the block is
    copied to a fresh one (K/V and scale planes), the slot's table
    repointed. Blocks whose refcount reaches 0 while a prefix index names
    them park on a cached free list: reclaimable (LRU, after the plain
    free list, invalidating their entry through `evict_hook`) but kept
    until reused."""

    def __init__(self, model, slots: int, num_blocks: Optional[int] = None,
                 block_size: int = 16, quantized: bool = False):
        if slots < 1:
            raise ValueError(f"slots must be >= 1, got {slots}")
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        M = model.cfg.max_seq_len
        self.model = model
        self.slots = slots
        self.block_size = block_size
        self.quantized = quantized
        self.blocks_per_seq = -(-M // block_size)  # nb: ceil(M / bs)
        if num_blocks is None:
            # dense-equivalent capacity: every slot can hold max_seq_len
            num_blocks = slots * self.blocks_per_seq
        if num_blocks < self.blocks_per_seq:
            raise ValueError(f"num_blocks ({num_blocks}) cannot hold even one max-length "
                             f"request ({self.blocks_per_seq} blocks)")
        self.num_blocks = num_blocks
        self.invalid_block = num_blocks  # addresses the sink
        self.tree = init_paged_cache(model, num_blocks, block_size, quantized=quantized)
        self.block_tables = np.full((slots, self.blocks_per_seq), self.invalid_block, np.int32)
        self.lengths = np.zeros((slots,), np.int32)
        self._in_use = np.zeros((slots,), bool)
        self._free_slots: List[int] = list(range(slots))
        self._free_blocks: List[int] = list(range(num_blocks))
        self._slot_blocks: List[List[int]] = [[] for _ in range(slots)]
        # prefix sharing: per-block refcounts, the blocks a prefix index
        # names, the refcount-0-but-indexed cached list (LRU reclaim
        # order), the index's invalidation hook and the CoW copy counter
        self._refcount = np.zeros((num_blocks,), np.int32)
        self._indexed: set = set()
        self._cached_blocks: "OrderedDict[int, None]" = OrderedDict()
        self.evict_hook: Optional[Callable[[int], None]] = None
        self.cow_copies = 0

    # -- slot lifecycle ----------------------------------------------------
    def allocate(self) -> Optional[int]:
        """A free slot index (its blocks come on write), or None."""
        if not self._free_slots:
            return None
        s = self._free_slots.pop(0)
        self._in_use[s] = True
        return s

    def free(self, slot: int) -> int:
        """Retire a slot: decrement its blocks' refcounts and invalidate its
        table row. Returns how many blocks became reclaimable."""
        if not self._in_use[slot]:
            raise ValueError(f"slot {slot} is not allocated")
        n = 0
        for b in self._slot_blocks[slot]:
            n += self._decref(b)
        self._slot_blocks[slot] = []
        self.block_tables[slot, :] = self.invalid_block
        self._in_use[slot] = False
        self.lengths[slot] = 0
        self._free_slots.append(slot)
        return n

    def reset(self) -> None:
        """Free every slot and block; the pool tensors are not cleared."""
        for s in range(self.slots):
            if self._in_use[s]:
                self.free(s)

    # -- block plane -------------------------------------------------------
    def blocks_for(self, tokens: int) -> int:
        """Blocks needed to hold `tokens` positions."""
        return -(-tokens // self.block_size)

    def ensure_blocks(self, slot: int, upto_pos: int) -> bool:
        """Grow `slot`'s table so position `upto_pos` is writable. All or
        nothing: False, allocating nothing, when the reclaimable set cannot
        cover the growth (the engine's backpressure / preemption signal)."""
        if not self._in_use[slot]:
            raise ValueError(f"slot {slot} is not allocated")
        if not 0 <= upto_pos < self.blocks_per_seq * self.block_size:
            raise ValueError(f"position {upto_pos} outside the slot's "
                             f"{self.blocks_per_seq}-block table")
        have = len(self._slot_blocks[slot])
        need = upto_pos // self.block_size + 1 - have
        if need <= 0:
            return True
        if need > self.free_blocks:
            return False
        for j in range(have, have + need):
            b = self._take_block()
            self._refcount[b] = 1
            self._slot_blocks[slot].append(b)
            self.block_tables[slot, j] = b
        return True

    # -- refcount plumbing -------------------------------------------------
    def _take_block(self) -> int:
        """Pop a reusable block: the plain free list first (FIFO), then the
        cached list oldest-first, invalidating its prefix-index entry."""
        if self._free_blocks:
            return self._free_blocks.pop(0)
        b, _ = self._cached_blocks.popitem(last=False)
        if self.evict_hook is not None:
            self.evict_hook(b)
        self._indexed.discard(b)
        return b

    def _ref_block(self, b: int) -> None:
        """Add one reference to `b`; a refcount-0 block leaves the free set."""
        if self._refcount[b] == 0:
            if b in self._cached_blocks:
                del self._cached_blocks[b]
            elif b in self._free_blocks:
                self._free_blocks.remove(b)
        self._refcount[b] += 1

    def _decref(self, b: int) -> int:
        """Drop one reference; 1 when the block became reclaimable."""
        self._refcount[b] -= 1
        if self._refcount[b] > 0:
            return 0
        if b in self._indexed:
            self._cached_blocks[b] = None
        else:
            self._free_blocks.append(b)
        return 1

    def _deindex(self, b: int) -> None:
        """Prefix-index callback: the entry naming `b` is gone."""
        self._indexed.discard(b)
        if b in self._cached_blocks:
            del self._cached_blocks[b]
            self._free_blocks.append(b)

    def mark_indexed(self, b: int) -> None:
        """Prefix-index callback: an index node now names `b`."""
        self._indexed.add(b)

    def refcount(self, b: int) -> int:
        return int(self._refcount[b])

    def attach_prefix(self, slot: int, blocks: Sequence[int]) -> None:
        """Adopt already-filled `blocks` as the slot's leading logical
        blocks (a prefix-cache hit); the slot must hold no blocks yet."""
        if not self._in_use[slot]:
            raise ValueError(f"slot {slot} is not allocated")
        if self._slot_blocks[slot]:
            raise ValueError(f"slot {slot} already holds blocks; prefix attach must "
                             f"precede the first write")
        for j, b in enumerate(blocks):
            self._ref_block(b)
            self._slot_blocks[slot].append(b)
            self.block_tables[slot, j] = b

    def needs_cow(self, slot: int, pos: int) -> bool:
        """Would a write at `pos` hit a block the slot may not mutate?"""
        lb = pos // self.block_size
        if lb >= len(self._slot_blocks[slot]):
            return False
        b = self._slot_blocks[slot][lb]
        return self._refcount[b] > 1 or b in self._indexed

    def cow_block(self, slot: int, pos: int) -> bool:
        """Copy-on-write: make the block holding `pos` private to `slot`.
        When the pool is dry and only an index entry protects the block,
        the entry is dropped instead. False when a copy is needed and no
        block is reclaimable."""
        lb = pos // self.block_size
        if lb >= len(self._slot_blocks[slot]):
            return True
        b = self._slot_blocks[slot][lb]
        shared = self._refcount[b] > 1
        if not shared and b not in self._indexed:
            return True
        if not shared and self.free_blocks == 0:
            if self.evict_hook is not None:
                self.evict_hook(b)
            self._indexed.discard(b)
            return True
        if self.free_blocks == 0:
            return False
        new = self._take_block()
        self._refcount[new] = 1
        for buf in _leaves(self.tree):  # K, V and the scale planes
            blocks = _blocks(buf)
            blocks[new].copy_(blocks[b])
        self._slot_blocks[slot][lb] = new
        self.block_tables[slot, lb] = new
        self._decref(b)
        self.cow_copies += 1
        return True

    # -- introspection -----------------------------------------------------
    @property
    def active_slots(self) -> List[int]:
        return [s for s in range(self.slots) if self._in_use[s]]

    @property
    def occupancy(self) -> float:
        return float(self._in_use.sum()) / self.slots

    @property
    def free_blocks(self) -> int:
        """Reclaimable blocks: the plain free list plus cached prefix blocks."""
        return len(self._free_blocks) + len(self._cached_blocks)

    @property
    def live_blocks(self) -> int:
        """Blocks some slot references, each shared block once."""
        return self.num_blocks - self.free_blocks

    @property
    def cached_free_blocks(self) -> int:
        return len(self._cached_blocks)

    @property
    def shared_blocks(self) -> int:
        return int((self._refcount > 1).sum())

    @property
    def total_block_refs(self) -> int:
        return int(self._refcount.sum())

    @property
    def bytes_deduplicated(self) -> int:
        """Pool bytes sharing saves against a copy per reference."""
        extra = int(np.maximum(self._refcount - 1, 0).sum())
        return extra * self.bytes_per_block

    @property
    def pool_utilization(self) -> float:
        return self.live_blocks / self.num_blocks

    @functools.cached_property
    def bytes_per_block(self) -> int:
        """Device bytes one block pins across every layer (K + V, plus the
        scale planes when quantized); the sink is not counted."""
        cfg = self.model.cfg
        itemsize = 1 if self.quantized else _itemsize(cfg.dtype)
        return (2 * cfg.n_layers * self.block_size * cfg.kv_heads * cfg.head_dim * itemsize
                + self.scale_bytes_per_block)

    @functools.cached_property
    def scale_bytes_per_block(self) -> int:
        if not self.quantized:
            return 0
        cfg = self.model.cfg
        return 2 * cfg.n_layers * self.block_size * cfg.kv_heads * 4

    @property
    def wire_dtype(self) -> str:
        return "int8" if self.quantized else _dtype_name(self.model.cfg.dtype)

    @property
    def effective_slots(self) -> int:
        """How many max_seq_len requests the pool holds at once."""
        return self.num_blocks // self.blocks_per_seq

    @property
    def bytes_live(self) -> int:
        return self.live_blocks * self.bytes_per_block

    @functools.cached_property
    def dense_bytes_per_request(self) -> int:
        """One slot's cost in the dense (slots, max_seq_len, ...) layout."""
        cfg = self.model.cfg
        return (2 * cfg.n_layers * cfg.max_seq_len * cfg.kv_heads * cfg.head_dim
                * _itemsize(cfg.dtype))

    def slot_blocks(self, slot: int) -> List[int]:
        return list(self._slot_blocks[slot])

    def exclusive_blocks(self, slot: int) -> int:
        """Blocks only `slot` references (what evicting it reclaims)."""
        return sum(1 for b in self._slot_blocks[slot] if self._refcount[b] == 1)

    # -- migration payloads ------------------------------------------------
    def export_blocks(self, block_ids: Sequence[int]):
        """Host snapshot of the given blocks across every pool leaf, in
        table order, raw (bf16 words, int8 payloads and their scales bit
        for bit), the migration payload: a tree shaped like the pool with
        the block axis cut to `len(block_ids)`, CPU tensors in the pool's
        dtypes, in the global layout whatever the pool's TP degree."""
        idx = torch.as_tensor(list(block_ids), dtype=torch.long,
                              device=model_device(self.model))
        return {layer: {"attn": {name: _export_leaf(buf, idx)
                                 for name, buf in node["attn"].items()}}
                for layer, node in self.tree.items()}

    def import_blocks(self, dst_ids: Sequence[int], payload) -> None:
        """Land an `export_blocks` payload onto blocks `dst_ids` (same
        order and count), in place, onto this pool's layout. Bytes land
        verbatim: a leaf of another dtype raises."""
        idx = torch.as_tensor(list(dst_ids), dtype=torch.long,
                              device=model_device(self.model))
        for layer, node in self.tree.items():
            for name, buf in node["attn"].items():
                _import_leaf(buf, idx, payload[layer]["attn"][name])

    def __repr__(self) -> str:
        return (f"PagedKVCache(slots={self.slots}, blocks={self.live_blocks}/{self.num_blocks}, "
                f"block_size={self.block_size}, active={int(self._in_use.sum())}, "
                f"shared={self.shared_blocks}, cached={self.cached_free_blocks}, "
                f"wire={self.wire_dtype})")
