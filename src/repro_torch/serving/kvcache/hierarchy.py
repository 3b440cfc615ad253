"""The KV memory hierarchy: a drop-in ``KVPool`` with two extra tiers.

HBM blocks are partitioned into three populations whose sum is constant::

    num_blocks == raw_free + Σ private (per-request) + cached (prefix cache)

The prefix cache splits into *pinned* blocks (refcount > 0 — some live
request references them) and *evictable* blocks (refcount 0 — reclaimed
LRU-first under allocation pressure). The pool's ``free`` property counts
evictable blocks as allocatable, because eviction is instantaneous in the
model; ``raw_free`` is the physically-empty count.

Every population is tracked at *physical block id* granularity (the base
pool's free list): a request's ``block_table(rid)`` lists its logical
blocks in order — shared prefix-cache ids first, then private ids. When a
real engine is bound (``bind_runtime``), those ids index actual device
pages, so prefix sharing is two block tables pointing at the same page,
and the swap tier moves real page bytes through the runtime's
``swap_out``/``swap_in`` hooks. The simulator binds no runtime and sees
pure accounting, exactly as before.

The host tier is a separate block pool (``HostSwapPool``); swapped blocks
never count against HBM. Swap-in cost is *not* charged here — the
scheduler adds the pending bytes to the iteration's ``BatchPlanCost`` so
both the latency predictor and the execution oracle price the PCIe
transfer (see ``core/scheduler.py`` / ``core/predictor.py``).

With ``enable_prefix=False`` and ``enable_swap=False`` every override
degenerates to the flat-pool arithmetic (empty cache, zero-capacity host
pool), so a disabled hierarchy is bit-identical to ``KVPool`` — the
solo-replica guarantee tested in ``tests/test_kvcache.py``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

from repro_torch.core.kvpool import KVPool, blocks_for, kv_bytes_per_block
from repro_torch.models.config import ModelConfig
from repro_torch.serving.kvcache.prefix import PrefixCache, block_hashes
from repro_torch.serving.kvcache.swap import HostSwapPool


@dataclass(frozen=True)
class KVCacheConfig:
    enable_prefix: bool = False
    enable_swap: bool = False
    host_bytes: float = 64e9       # host-RAM budget for the swap tier


class KVHierarchy(KVPool):
    def __init__(self, num_blocks: int, block_size: int = 256,
                 cfg: KVCacheConfig | None = None,
                 bytes_per_block: int = 0,
                 host_blocks: int | None = None,
                 max_seqs: int | None = None):
        super().__init__(num_blocks, block_size, max_seqs=max_seqs)
        self.cfg = cfg or KVCacheConfig()
        self.bytes_per_block = bytes_per_block
        if self.cfg.enable_swap and bytes_per_block <= 0:
            # without real block bytes the swap tier would silently size
            # itself to zero AND price swap-ins at zero seconds
            raise ValueError(
                "enable_swap needs bytes_per_block > 0 to size the host "
                "pool and price PCIe transfers — construct via from_memory"
                " or pass bytes_per_block explicitly")
        if host_blocks is None:
            host_blocks = (int(self.cfg.host_bytes // bytes_per_block)
                           if bytes_per_block else 0)
        self.host = HostSwapPool(host_blocks if self.cfg.enable_swap else 0)
        self.prefix = PrefixCache()
        self._shared: Dict[int, int] = {}         # rid -> pinned cache blocks
        self._hashes: Dict[int, Tuple[int, ...]] = {}
        self._swapped: Dict[int, int] = {}        # rid -> host-tier tokens
        # cumulative swap traffic (bytes over PCIe), scraped by the obs
        # registry; never read by any scheduling decision
        self.swapped_out_bytes_total = 0.0
        self.swapped_in_bytes_total = 0.0

    @classmethod
    def from_memory(cls, cfg: ModelConfig, hbm_bytes: float,
                    weight_frac_free: float = 0.45, block_size: int = 256,
                    cache_cfg: KVCacheConfig | None = None,
                    max_seqs: Optional[int] = None,
                    kv_bytes_per: int = 2,
                    tp_degree: int = 1) -> "KVHierarchy":
        # delegate sizing to the flat pool so the two can never diverge
        # (the disabled-hierarchy bit-identity guarantee depends on it)
        base = KVPool.from_memory(cfg, hbm_bytes,
                                  weight_frac_free=weight_frac_free,
                                  block_size=block_size,
                                  tp_degree=tp_degree)
        return cls(base.num_blocks, block_size, cfg=cache_cfg,
                   bytes_per_block=kv_bytes_per_block(
                       cfg, block_size, bytes_per=kv_bytes_per),
                   max_seqs=max_seqs)

    # ------------------------------------------------ accounting
    @property
    def used(self) -> int:
        """Non-reclaimable HBM blocks: private + pinned cache blocks.
        Evictable cache blocks count as free (eviction is instant)."""
        return sum(self._owned.values()) + self.prefix.n_pinned

    @property
    def raw_free(self) -> int:
        """Physically-empty blocks (evictable cache blocks excluded)."""
        return (self.num_blocks - sum(self._owned.values())
                - self.prefix.n_cached)

    def held(self, rid: int) -> int:
        """HBM blocks resident for ``rid``: private + shared references.
        Host-tier blocks are NOT held — re-admitting a swapped request
        must re-acquire them, which is exactly what the scheduler's
        ``blocks_for(prefilled + take) - held`` need formula charges."""
        return self._owned.get(rid, 0) + self._shared.get(rid, 0)

    def private_blocks(self, rid: int) -> int:
        return self._owned.get(rid, 0)

    def _make_room(self, need: int) -> None:
        short = need - self.raw_free
        if short > 0:
            ids = self.prefix.evict(short)
            assert len(ids) >= short, \
                "free counted evictable blocks that vanished"
            self._free_ids.extend(ids)

    def grow(self, rid: int, total_tokens: int) -> bool:
        need = blocks_for(total_tokens, self.block_size) \
            - self.covered_blocks(rid)
        if need > self.free:
            return False
        if need > 0:
            self._make_room(need)
            self._alloc_ids(rid, need)
            self._owned[rid] = self._owned.get(rid, 0) + need
        return True

    def reclaim_prefix(self, rid: int, upto_blocks: int,
                       start: int = 0) -> int:
        """SWA reclamation with the hierarchy's extra tenants protected:
        the shared prefix head belongs to the cache (other tables point at
        those pages), and hash-covered blocks may still be promoted into
        it — both stay pinned; only the private tail past them frees.
        Swap-parked requests hold no reclaimable HBM blocks."""
        if rid in self._swapped or self.host.held(rid) > 0:
            return 0
        head = max(start, self._shared.get(rid, 0),
                   len(self._hashes.get(rid, ())))
        return super().reclaim_prefix(rid, upto_blocks, start=head)

    # ------------------------------------------------ prefix tier
    def attach(self, req) -> None:
        """Match ``req``'s shareable prefix and skip those prefill tokens.
        Called when a fresh (or resumed-after-recompute) request enters a
        prefill queue; no-op for requests that already carry KV state.
        With a bound engine runtime, only configs the engine can share
        (no recurrent layers) participate — Mamba state is not a
        per-block KV quantity, so a prefix hit could not skip its
        recurrence (docs/engine.md §Paged KV layout)."""
        if not self.cfg.enable_prefix:
            return
        if self.runtime is not None \
                and not getattr(self.runtime, "prefix_sharing_ok", True):
            return
        rid = req.rid
        if (req.prefilled > 0 or rid in self._shared
                or rid in self._swapped):
            return
        hashes = block_hashes(req, self.block_size)
        if not hashes:
            return
        self._hashes[rid] = hashes
        k = self.prefix.lock(hashes)
        self._shared[rid] = k
        if k:
            # the request's logical blocks 0..k-1 ARE the cache's physical
            # blocks — a real engine's block table points straight at them
            assert rid not in self._tables, \
                "prefix attach on a request already holding blocks"
            self._tables[rid] = self.prefix.phys_ids(hashes[:k])
            self._touch(rid)
        hit = k * self.block_size
        req.prefilled = hit
        req.cache_hit_tokens = hit
        self.prefix.hit_tokens += hit
        self.prefix.miss_tokens += (len(hashes) - k) * self.block_size

    def promote(self, rid: int, prefilled: int) -> None:
        """Publish newly-prefilled shareable blocks into the cache: each
        moves from this request's private population to the cached one
        (we keep a reference), so ``held`` and ``used`` are unchanged.
        When another request concurrently prefilled the same block, the
        duplicate physical copy is freed and this request's table entry
        repoints to the canonical page — engine block tables are rebuilt
        from the pool each iteration, so the repoint is picked up
        automatically (KV content is bitwise identical either way)."""
        if not self.cfg.enable_prefix:
            return
        hashes = self._hashes.get(rid)
        if not hashes:
            return
        target = min(len(hashes), prefilled // self.block_size)
        cur = self._shared.get(rid, 0)
        table = self._tables.get(rid)
        for i in range(cur, target):
            assert self._owned.get(rid, 0) > 0, \
                "promote without a private block to publish"
            mine = table[i]
            if self.prefix.acquire(hashes[i]):
                # dedup: the canonical copy wins, my duplicate page frees
                table[i] = self.prefix.blocks[hashes[i]].phys
                self._touch(rid)
                self._free_ids.append(mine)
            else:
                self.prefix.insert(hashes[i], phys=mine)
            # either way the duplicate private copy is freed
            self._owned[rid] -= 1
            if self._owned[rid] == 0:
                del self._owned[rid]
        if target > cur:
            self._shared[rid] = target

    # ------------------------------------------------ swap tier
    def on_relegate(self, rid: int, prefilled: int) -> int:
        priv = self._owned.get(rid, 0)
        shared0 = self._shared.get(rid, 0)
        if any(i < 0 for i in self._tables.get(rid, ())[shared0:]):
            # SWA-reclaimed holes break the swap tier's block<->logical
            # correspondence (swap-in re-grants a contiguous private
            # tail); fall back to free-and-recompute for this corner
            self.release(rid)
            return 0
        if self.cfg.enable_swap and self.host.free >= priv:
            if priv:
                shared = self._shared.get(rid, 0)
                table = self._tables[rid]
                priv_ids = table[shared:]
                if self.runtime is not None:
                    self.runtime.swap_out(rid, priv_ids)
                del table[shared:]
                self._touch(rid)
                if not table:
                    del self._tables[rid]
                    self._tver.pop(rid, None)
                self._free_ids.extend(priv_ids)
            self._owned.pop(rid, None)
            self.host.put(rid, priv)
            self.swapped_out_bytes_total += priv * float(
                self.bytes_per_block)
            host_tokens = prefilled - self._shared.get(rid, 0) \
                * self.block_size
            if host_tokens > 0:
                self._swapped[rid] = host_tokens
            # host_tokens == 0: everything resident is shared prefix —
            # nothing travels to the host tier; the request resumes
            # straight off the pinned cache pages (resident_tokens)
            # shared prefix blocks stay pinned while parked: the host copy
            # is only resumable on top of the exact prefix it extends
            return prefilled
        # host full (or swap disabled): vLLM-style free-and-recompute
        self.release(rid)
        return 0

    def swapped_tokens(self, rid: int) -> int:
        return self._swapped.get(rid, 0)

    def resident_tokens(self, rid: int) -> int:
        """Shared prefix pages hold the request's leading tokens in HBM:
        a fresh cache hit AND a swap-parked request whose resident state
        is entirely shared (relegated exactly at the prefix boundary)
        both resume from here."""
        return self._shared.get(rid, 0) * self.block_size

    def swap_in_bytes(self, rid: int) -> float:
        return self.host.held(rid) * float(self.bytes_per_block)

    def swap_in(self, rid: int) -> None:
        n = self.host.take(rid)
        self._swapped.pop(rid, None)
        if n > 0:
            assert n <= self.free, "swap-in admitted beyond pool capacity"
            self.swapped_in_bytes_total += n * float(self.bytes_per_block)
            self._make_room(n)
            ids = self._alloc_ids(rid, n)
            self._owned[rid] = self._owned.get(rid, 0) + n
            if self.runtime is not None:
                self.runtime.swap_in(rid, ids)

    def host_receive(self, rid: int, blocks: int, tokens: int) -> bool:
        """Land a migrated request's transferred KV in the host tier (the
        fleet's swapped-offload path). The request arrives parked: its
        swap-in cost is charged when a scheduler admits it."""
        if not self.cfg.enable_swap or self.host.free < blocks:
            return False
        self.host.put(rid, blocks)
        self._swapped[rid] = tokens
        return True

    # ------------------------------------------------ release
    def release(self, rid: int) -> None:
        self._owned.pop(rid, None)
        shared = self._shared.pop(rid, 0)
        hashes = self._hashes.pop(rid, ())
        table = self._tables.pop(rid, None)
        self._tver.pop(rid, None)
        if table is not None and len(table) > shared:
            # only the private tail returns to the free list; the shared
            # head belongs to the cache (freed on eviction) and
            # SWA-reclaimed -1 holes are already free
            self._free_ids.extend(i for i in table[shared:] if i >= 0)
        if shared:
            self.prefix.unlock(hashes[:shared])
        self.host.take(rid)
        self._swapped.pop(rid, None)
        if self.runtime is not None:
            self.runtime.drop(rid)

    # ------------------------------------------------ telemetry
    def prefix_hit_rate(self) -> float:
        tot = self.prefix.hit_tokens + self.prefix.miss_tokens
        return self.prefix.hit_tokens / tot if tot else 0.0

    def host_utilization(self) -> float:
        return self.host.used / max(1, self.host.capacity_blocks)
