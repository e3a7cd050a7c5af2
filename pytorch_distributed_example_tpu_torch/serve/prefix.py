"""Radix prefix index — cross-request (and, gated, cross-tenant) KV
prefix sharing over the refcounted paged block pool.

A copy of the reference's `serve/prefix.py`.

The millions-of-users traffic shape is dominated by shared system
prompts and few-shot preambles: without sharing, every request
re-prefills and re-stores identical KV blocks, so TTFT and pool bytes
scale with TOTAL tokens instead of UNIQUE tokens. This module is the
lookup half of the fix; `serve/cache.py`'s refcounts + copy-on-write
are the storage half.

Structure: a radix tree per SCOPE (the tenancy boundary — see
`ServeEngine._prefix_scope`), one node per physical block. A node's
edge label is the tuple of token ids whose K/V the block holds: full
interior nodes carry exactly ``block_size`` tokens; PARTIAL leaves
carry fewer (a prompt's tail that stopped mid-block). Children with a
common first token may coexist (a partial tail next to the full block
that later extended it); `match` picks the longest common prefix.

* ``match(scope, tokens)`` — longest cached prefix of `tokens`:
  returns (block ids, matched token count). Full-block matches descend;
  the first partial-boundary divergence (token mismatch inside a node,
  or a partial leaf) contributes its common-prefix tokens and stops —
  the attaching slot adopts that block too and copy-on-writes it at
  first write. The match is capped at ``len(tokens) - 1``: at least one
  position must be prefilled for real, because the first sampled token
  needs the prompt-end logits row. Read-only — attaching (refcounts)
  is the cache's `attach_prefix`.
* ``insert(scope, tokens, blocks)`` — index a freshly prefilled
  prompt's blocks. Called at PREFILL COMPLETION, before the request's
  first decode write lands, so every indexed block holds PROMPT K/V
  only — decoded (non-prefix) tokens are never indexed, which is what
  makes the cross-tenant opt-in safe by construction. Chunks whose
  content is already indexed (the very blocks this request attached,
  or a concurrent duplicate) descend without re-indexing.
* Eviction — the index holds NO references. A block whose refcount
  drops to 0 parks on the cache's CACHED list; when the pool reclaims
  it (LRU, plain free list first), the cache calls the hook this index
  installs (`PagedKVCache.evict_hook`) and the node AND ITS SUBTREE
  leave the tree (a child's content is unreachable without its
  parent's — and since a holder of any descendant also holds every
  ancestor, a reclaimed block's subtree is guaranteed unreferenced).
  This composes with the class-aware engine eviction untouched:
  preempting a victim only decrements refcounts, so shared prefix
  blocks survive their victims.

Single-owner like the engine (one thread mutates); `stats()` is plain
ints, snapshotted by `ServeMetrics` under its own lock.
"""

from __future__ import annotations

from typing import Dict, Hashable, List, Optional, Sequence, Tuple

__all__ = ["PrefixIndex", "prefix_scope"]


def prefix_scope(classes, klass: str, tenant: str) -> Hashable:
    """The sharing boundary for a request's prefix-cache entries: a
    PRIVATE per-tenant scope unless the request's class opts into
    cross-tenant sharing (`ClassSpec.share_prefix` — both sides of any
    cross-tenant hit opted in by construction, since matching only ever
    happens within one scope).

    The ONE definition of the scope key: the engine's radix index and
    the data-parallel router's session affinity both key on
    it, which is exactly what keeps a tenant's shared blocks hot on one
    replica — the router cannot drift from the cache's tenancy model
    because they call the same function."""
    if classes is not None:
        spec = classes.get(klass)
        if spec is not None and spec.share_prefix:
            return "*"
    return ("tenant", tenant)


class _Node:
    """One indexed physical block: `tokens` it holds (len < block_size
    for a partial tail), its children keyed by first token (a LIST —
    siblings may share one), and its parent (None = scope root)."""

    __slots__ = ("tokens", "block", "children", "parent")

    def __init__(self, tokens: Tuple[int, ...], block: int,
                 parent: Optional["_Node"]):
        self.tokens = tokens
        self.block = block
        self.children: Dict[int, List["_Node"]] = {}
        self.parent = parent

    def __repr__(self) -> str:
        return f"_Node(block={self.block}, n_tokens={len(self.tokens)})"


def _lcp_at(a: Sequence[int], b: Sequence[int], start: int) -> int:
    """Common prefix length of `a` and `b[start:]` WITHOUT slicing —
    match() probes every sibling at every level, so copying the prompt
    remainder per probe would make admission quadratic in prompt
    length."""
    n = min(len(a), len(b) - start)
    i = 0
    while i < n and a[i] == b[start + i]:
        i += 1
    return i


class PrefixIndex:
    def __init__(self, cache):
        self.cache = cache
        self.block_size = int(cache.block_size)
        # scope -> root children dict (first token -> [nodes])
        self._roots: Dict[Hashable, Dict[int, List[_Node]]] = {}
        self._by_block: Dict[int, Tuple[Hashable, _Node]] = {}
        cache.evict_hook = self._on_block_reclaim
        self.hits = 0
        self.misses = 0
        self.tokens_reused = 0
        self.blocks_attached = 0
        self.inserts = 0
        self.evicted_nodes = 0

    # -- lookup ------------------------------------------------------------
    def match(
        self, scope: Hashable, tokens: Sequence[int]
    ) -> Tuple[List[int], int]:
        """Longest cached prefix of `tokens` within `scope`: (physical
        block ids in logical order, matched token count). Counts a hit
        (and the reuse stats) when at least one token matched; the
        caller attaches via `PagedKVCache.attach_prefix` and starts
        prefill at the matched position."""
        cap = len(tokens) - 1  # the prompt-end logits row must be live
        children = self._roots.get(scope)
        blocks: List[int] = []
        matched = 0
        while children is not None and matched < cap:
            best: Optional[_Node] = None
            best_l = 0
            for node in children.get(tokens[matched], ()):
                l = _lcp_at(node.tokens, tokens, matched)
                if l > best_l:
                    best, best_l = node, l
            if best is None:
                break
            take = min(best_l, cap - matched)
            blocks.append(best.block)
            matched += take
            if take < len(best.tokens) or len(best.tokens) < self.block_size:
                break  # partial-boundary divergence: CoW territory
            children = best.children
        if matched > 0:
            self.hits += 1
            self.tokens_reused += matched
            self.blocks_attached += len(blocks)
        else:
            self.misses += 1
        return blocks, matched

    # -- indexing ----------------------------------------------------------
    def insert(
        self, scope: Hashable, tokens: Sequence[int],
        blocks: Sequence[int],
    ) -> int:
        """Index a prefilled prompt: `blocks` hold the K/V of `tokens`
        in block_size chunks (the slot's leading blocks at prefill
        completion — pristine prompt content, decode has not written
        yet). Chunks already indexed with equal-or-longer content
        descend; new nodes (including the partial tail) are created and
        their blocks marked index-protected in the cache. Returns the
        number of nodes created."""
        bs = self.block_size
        children = self._roots.setdefault(scope, {})
        parent: Optional[_Node] = None
        created = 0
        for k in range(-(-len(tokens) // bs)):
            chunk = tuple(tokens[k * bs:(k + 1) * bs])
            existing = None
            for node in children.get(chunk[0], ()):
                if (
                    len(node.tokens) >= len(chunk)
                    and node.tokens[: len(chunk)] == chunk
                ):
                    existing = node
                    break
            if existing is not None:
                # identical (or longer) content already cached — the
                # usual case for the very blocks this request attached
                if len(chunk) < bs:
                    break
                parent, children = existing, existing.children
                continue
            b = int(blocks[k])
            if b in self._by_block:
                # one block, one node: this block already backs an
                # entry elsewhere (cannot happen for fresh/CoW'd slot
                # blocks; defensive for misuse)
                break
            node = _Node(chunk, b, parent)
            children.setdefault(chunk[0], []).append(node)
            self._by_block[b] = (scope, node)
            self.cache.mark_indexed(b)
            created += 1
            if len(chunk) < bs:
                break
            parent, children = node, node.children
        self.inserts += 1
        return created

    # -- eviction ----------------------------------------------------------
    def _on_block_reclaim(self, b: int) -> None:
        """`PagedKVCache` hook: physical block `b` is being handed to a
        new owner — drop its node and the node's whole subtree (all
        guaranteed unreferenced: any holder of a descendant holds its
        ancestors, and `b` reached refcount 0 to be reclaimable)."""
        ent = self._by_block.get(b)
        if ent is None:
            return
        scope, node = ent
        container = (
            node.parent.children if node.parent is not None
            else self._roots[scope]
        )
        siblings = container.get(node.tokens[0])
        if siblings is not None:
            try:
                siblings.remove(node)
            except ValueError:
                pass
            if not siblings:
                container.pop(node.tokens[0], None)
        stack = [node]
        while stack:
            n = stack.pop()
            self._by_block.pop(n.block, None)
            self.cache._deindex(n.block)
            self.evicted_nodes += 1
            for lst in n.children.values():
                stack.extend(lst)

    # -- introspection -----------------------------------------------------
    @property
    def nodes(self) -> int:
        return len(self._by_block)

    def stats(self) -> Dict[str, int]:
        total = self.hits + self.misses
        return {
            "hits": self.hits,
            "misses": self.misses,
            "hit_rate": round(self.hits / total, 4) if total else 0.0,
            "prefix_tokens_reused": self.tokens_reused,
            "blocks_attached": self.blocks_attached,
            "inserts": self.inserts,
            "nodes": self.nodes,
            "evicted_nodes": self.evicted_nodes,
        }

    def __repr__(self) -> str:
        return (
            f"PrefixIndex(nodes={self.nodes}, scopes={len(self._roots)}, "
            f"hits={self.hits}, misses={self.misses})"
        )
