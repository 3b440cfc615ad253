"""Refcounted prefix cache over chained token-block hashes.

Block identity is a hash chain (radix-style): block ``i``'s hash folds in
block ``i-1``'s hash, so two requests share block ``i`` iff their prompts
agree on ALL tokens up to the end of block ``i``. The simulator carries no
real token ids; content identity comes from :attr:`Request.prefix_id`
(requests with the same ``prefix_id`` share their first ``prefix_len``
prompt tokens — a multi-tenant system prompt) with everything past the
shared region unique per request. The chain therefore stops at the last
full block inside the shared region: later blocks can never match anyone
else's, so caching them would only pollute the LRU.

Eviction is LRU over unreferenced blocks only — a block a live request
holds a reference to (``refs > 0``) is pinned and can never be dropped.
"""
from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Tuple

from repro_torch.core.request import Request


def block_hashes(req: Request, block_size: int) -> Tuple[int, ...]:
    """Chained per-block hashes for the *shareable* prefix of ``req``.

    Only blocks that lie fully inside ``req.prefix_len`` are hashable, and
    never the request's final prompt token (always recomputed so a request
    whose whole prompt is a cache hit still emits its first token through
    a real prefill chunk — the vLLM rule).
    """
    if req.prefix_id is None or req.prefix_len <= 0:
        return ()
    shareable = min(req.prefix_len, req.prompt_len - 1)
    n = shareable // block_size
    out: List[int] = []
    h = hash(("kvprefix", req.prefix_id))
    for i in range(n):
        h = hash((h, req.prefix_id, i))
        out.append(h)
    return tuple(out)


@dataclass
class CachedBlock:
    h: int
    refs: int = 0          # live requests holding this block
    last_used: int = 0     # LRU clock (monotonic counter, not wall time)
    # physical block id in the owning pool (-1 when the pool is purely
    # counting, e.g. the simulator): a real engine's block tables point at
    # this id, so the SAME device page serves every sharing request
    phys: int = -1


@dataclass
class PrefixCache:
    """HBM-resident shared blocks, keyed by chained block hash."""
    blocks: Dict[int, CachedBlock] = field(default_factory=dict)
    # unreferenced blocks in eviction order (oldest unpin first) — keeps
    # evict() O(evicted) on the pool's allocation hot path
    _evictable: "OrderedDict[int, None]" = field(default_factory=OrderedDict)
    _clock: int = 0
    # accounting (the hit/miss invariant test audits these)
    hit_tokens: int = 0
    miss_tokens: int = 0
    evictions: int = 0
    insertions: int = 0

    # ------------------------------------------------ size accounting
    @property
    def n_cached(self) -> int:
        return len(self.blocks)

    @property
    def n_pinned(self) -> int:
        return len(self.blocks) - len(self._evictable)

    @property
    def n_evictable(self) -> int:
        return len(self._evictable)

    # ------------------------------------------------ lookup / pinning
    def match(self, hashes: Sequence[int]) -> int:
        """Longest cached chain prefix (in blocks). Non-binding."""
        n = 0
        for h in hashes:
            if h not in self.blocks:
                break
            n += 1
        return n

    def lock(self, hashes: Sequence[int]) -> int:
        """Pin the longest cached chain prefix; returns blocks pinned."""
        n = self.match(hashes)
        for h in hashes[:n]:
            self.acquire(h)
        return n

    def unlock(self, hashes: Sequence[int]) -> None:
        for h in hashes:
            b = self.blocks.get(h)
            if b is None:
                continue
            assert b.refs > 0, f"refcount underflow on block {h}"
            b.refs -= 1
            if b.refs == 0:
                self._evictable[h] = None     # joins the LRU tail

    def insert(self, h: int, phys: int = -1) -> None:
        """Publish a block the caller just prefilled (caller keeps a ref).
        ``phys`` records the physical block id now owned by the cache."""
        assert h not in self.blocks, "insert of an already-cached block"
        self._clock += 1
        self.blocks[h] = CachedBlock(h, refs=1, last_used=self._clock,
                                     phys=phys)
        self.insertions += 1

    def acquire(self, h: int) -> bool:
        """Take a ref on ``h`` if cached (dedup path for a block two
        requests prefilled concurrently). Returns False on miss."""
        b = self.blocks.get(h)
        if b is None:
            return False
        self._clock += 1
        if b.refs == 0:
            self._evictable.pop(h, None)      # re-pinned
        b.refs += 1
        b.last_used = self._clock
        return True

    def phys_ids(self, hashes: Sequence[int]) -> List[int]:
        """Physical ids of (cached) ``hashes``, in order."""
        return [self.blocks[h].phys for h in hashes]

    # ------------------------------------------------ eviction
    def evict(self, n: int) -> List[int]:
        """Drop up to ``n`` unreferenced blocks, least-recently-unpinned
        first. Returns the freed physical ids (``len`` = blocks freed; the
        counting-only caller just takes the length)."""
        freed: List[int] = []
        while len(freed) < n and self._evictable:
            h, _ = self._evictable.popitem(last=False)
            freed.append(self.blocks.pop(h).phys)
        self.evictions += len(freed)
        return freed
