"""Paged KV block pool — the scheduler-side memory accounting AND the
source of truth for *physical* block placement.

TPU adaptation (DESIGN.md §4.1): 256-token blocks (vs vLLM's 16-token CUDA
pages) so the Pallas decode kernel resolves the block table with one dynamic
slice per block. The pool tracks ownership so admission control, relegation
(blocks freed — vLLM-style recompute on resume) and decode growth are exact.

Since the paged-engine refactor the pool no longer only *counts* blocks: a
grant is a concrete list of physical block ids (``block_table(rid)``), in
logical order, drawn from one free list. The real JAX engine stores its
device KV cache as ``[num_blocks, block_size, ...]`` pages and indexes them
with exactly these ids, so scheduler accounting and device buffers can never
disagree (docs/engine.md §Paged KV layout). Simulator backends simply ignore
the ids — the counting behaviour is unchanged.

``max_seqs`` (optional) caps the number of *concurrent sequences* the
backend can hold (the engine's decode-batch rows / slots). It is advisory
metadata read by ``scheduler.admit_prefills`` — the pool itself never
rejects a grow on seats, because by the time the replica grows, the
scheduler has already taken the seat.

``KVPool`` is the flat, single-tier pool. The KV memory *hierarchy*
(shared-prefix cache + host-swap tier, ``repro.serving.kvcache``) subclasses
it; the no-op hooks below let the scheduler and replica drive either pool
through one interface — with a flat pool (or a hierarchy with every feature
disabled) the hooks change nothing, so solo behaviour is bit-identical.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Protocol, Sequence

from repro_torch.models.config import MAMBA, ModelConfig


def blocks_for(tokens: int, block_size: int) -> int:
    return (tokens + block_size - 1) // block_size


def kv_bytes_per_block(cfg: ModelConfig, block_size: int,
                       bytes_per: int = 2, kv_quant: bool = False) -> int:
    """Bytes one KV block costs on device. ``kv_quant``: paged int8 KV —
    head_dim int8 values plus one bf16 scale per (token, head), so a block
    costs ~half its bf16 size and the same HBM holds ~2x the blocks."""
    attn_layers = sum(1 for l in cfg.layers if l.mixer != MAMBA)
    per_head = (cfg.head_dim + 2) if kv_quant else cfg.head_dim * bytes_per
    return attn_layers * 2 * cfg.num_kv_heads * block_size * per_head


class PagedRuntime(Protocol):
    """Data-plane hooks a real engine registers on the pool
    (``bind_runtime``) so accounting moves trigger actual buffer traffic.
    The simulator never binds one; every call site guards on ``runtime``.
    """

    def swap_out(self, rid: int, block_ids: Sequence[int]) -> None:
        """Copy ``rid``'s pages at ``block_ids`` device -> host (the ids
        are about to be freed)."""
        ...

    def swap_in(self, rid: int, block_ids: Sequence[int]) -> None:
        """Copy ``rid``'s saved pages host -> device into the freshly
        granted ``block_ids`` (logical order matches swap_out)."""
        ...

    def drop(self, rid: int) -> None:
        """Discard any host-side saved state for ``rid``."""
        ...


class KVPool:
    def __init__(self, num_blocks: int, block_size: int = 256,
                 max_seqs: Optional[int] = None):
        self.num_blocks = num_blocks
        self.block_size = block_size
        self.max_seqs = max_seqs
        self._owned: Dict[int, int] = {}    # rid -> blocks held
        self._tables: Dict[int, List[int]] = {}   # rid -> physical ids
        # Physical ids are minted LAZILY from a high-water counter and
        # recycled through a stack: never materialize range(num_blocks)
        # (simulators build effectively-unbounded pools, e.g. 1e9 blocks
        # as "packing decides alone"). Invariant: _next_id == live ids +
        # len(_free_ids), and allocation only runs under the free-count
        # check, so every minted id is < num_blocks.
        self._free_ids: List[int] = []
        self._next_id = 0
        # Monotone table-mutation clock: every change to a rid's physical
        # table (grow, SWA reclaim, prefix attach, promote-time dedup
        # repoint, swap, release) stamps the rid with a globally-unique
        # epoch. Engines key cached device block tables on
        # ``table_version`` — a stale stamp can never alias a new table,
        # even across release/re-admit of the same rid.
        self._table_epoch = 0
        self._tver: Dict[int, int] = {}
        self.runtime = None                 # optional PagedRuntime

    @classmethod
    def from_memory(cls, cfg: ModelConfig, hbm_bytes: float,
                    weight_frac_free: float = 0.45,
                    block_size: int = 256,
                    max_seqs: Optional[int] = None,
                    kv_quant: bool = False,
                    tp_degree: int = 1) -> "KVPool":
        """Size the pool from the HBM left after weights (the paper's A100
        deployments keep roughly half of memory for KV). ``kv_quant``
        halves the per-block cost (int8 pages + scale pages), so the same
        budget yields ~2x resident blocks.

        ``tp_degree``: a tensor-parallel replica shards the kv-head axis,
        so each device stores only ``1/tp`` of a block's bytes — sizing
        against per-shard HBM must divide the per-block cost or the
        budget over-counts by the TP factor (when the heads don't divide
        the pages replicate and the full cost stands)."""
        per_block = kv_bytes_per_block(cfg, block_size, kv_quant=kv_quant)
        if tp_degree > 1 and cfg.num_kv_heads % tp_degree == 0:
            per_block //= tp_degree
        n = max(1, int(hbm_bytes * weight_frac_free / per_block))
        return cls(n, block_size, max_seqs=max_seqs)

    def bind_runtime(self, runtime: PagedRuntime) -> None:
        self.runtime = runtime

    @property
    def used(self) -> int:
        return sum(self._owned.values())

    @property
    def free(self) -> int:
        return self.num_blocks - self.used

    def held(self, rid: int) -> int:
        return self._owned.get(rid, 0)

    def covered_blocks(self, rid: int) -> int:
        """Logical blocks ``rid``'s table spans. Unlike ``held`` this
        counts SWA-reclaimed ``-1`` holes: a hole's tokens are dead to
        every attention window, so growth past it must not re-grant it."""
        return len(self._tables.get(rid, ()))

    def block_table(self, rid: int) -> Sequence[int]:
        """Physical block ids granted to ``rid``, in logical order: block
        ``j`` of the table holds tokens ``j*block_size .. (j+1)*bs - 1``."""
        return self._tables.get(rid, ())

    def table_version(self, rid: int) -> int:
        """Epoch of ``rid``'s last table mutation (0 = never granted).
        Unchanged version => ``block_table(rid)`` is byte-identical to the
        last read, so engines may reuse a cached/device-resident copy."""
        return self._tver.get(rid, 0)

    def _touch(self, rid: int) -> None:
        self._table_epoch += 1
        self._tver[rid] = self._table_epoch

    def _alloc_ids(self, rid: int, need: int) -> List[int]:
        ids = []
        for _ in range(need):
            if self._free_ids:
                ids.append(self._free_ids.pop())
            else:
                ids.append(self._next_id)
                self._next_id += 1
        self._tables.setdefault(rid, []).extend(ids)
        self._touch(rid)
        return ids

    def _free_table(self, rid: int) -> None:
        ids = self._tables.pop(rid, None)
        self._tver.pop(rid, None)
        if ids:
            # skip SWA-reclaimed -1 holes: those ids are already free
            self._free_ids.extend(i for i in ids if i >= 0)

    def can_grow(self, rid: int, total_tokens: int) -> bool:
        need = blocks_for(total_tokens, self.block_size) \
            - self.covered_blocks(rid)
        return need <= self.free

    def grow(self, rid: int, total_tokens: int) -> bool:
        need = blocks_for(total_tokens, self.block_size) \
            - self.covered_blocks(rid)
        if need > self.free:
            return False
        if need > 0:
            self._alloc_ids(rid, need)
            self._owned[rid] = self.held(rid) + need
        return True

    def reclaim_prefix(self, rid: int, upto_blocks: int,
                       start: int = 0) -> int:
        """SWA page reclamation: free ``rid``'s owned blocks in logical
        positions ``[start, upto_blocks)`` — their tokens have slid out of
        every sliding attention window and no future query can reach them.
        Freed table entries become ``-1`` holes so logical indexing (and
        ``covered_blocks``) is untouched; the engine's gather clips holes
        and the window mask zeroes exactly those lanes. Idempotent per
        position. Returns the number of blocks returned to the pool."""
        table = self._tables.get(rid)
        if not table:
            return 0
        freed = 0
        for j in range(start, min(upto_blocks, len(table))):
            if table[j] >= 0:
                self._free_ids.append(table[j])
                table[j] = -1
                freed += 1
        if freed:
            self._touch(rid)
            self._owned[rid] = self._owned.get(rid, 0) - freed
            if self._owned[rid] <= 0:
                del self._owned[rid]
        return freed

    def release(self, rid: int) -> None:
        """Drop every block associated with ``rid``. Idempotent: releasing
        an unknown (or already-released) rid is a no-op by design — finish,
        relegation, and migration paths may race to clean up."""
        self._owned.pop(rid, None)
        self._free_table(rid)

    def utilization(self) -> float:
        return self.used / max(1, self.num_blocks)

    # ------------------------------------------------ hierarchy hooks
    # No-ops on the flat pool; overridden by repro.serving.kvcache so the
    # replica/scheduler drive both pools through one interface.

    def attach(self, req) -> None:
        """Called when ``req`` enters a prefill queue: a hierarchy matches
        its shareable prefix against the cache and skips those tokens."""

    def promote(self, rid: int, prefilled: int) -> None:
        """Called after a prefill chunk lands: a hierarchy publishes the
        newly-completed shareable blocks into the prefix cache."""

    def on_relegate(self, rid: int, prefilled: int) -> int:
        """Relegation memory policy. Returns how many prefilled tokens are
        preserved for resume (0 = vLLM-style free-and-recompute; a
        hierarchy swaps to host and preserves them)."""
        self.release(rid)
        return 0

    def private_blocks(self, rid: int) -> int:
        """HBM blocks exclusively owned by ``rid`` (excludes shared
        prefix-cache references)."""
        return self.held(rid)

    def swapped_tokens(self, rid: int) -> int:
        """Prefilled tokens whose KV currently sits in the host tier."""
        return 0

    def resident_tokens(self, rid: int) -> int:
        """Leading prompt tokens whose KV is ALREADY resident in HBM for
        ``rid`` before it runs (shared prefix-cache pages). A paged
        engine admits such a request with its slot starting mid-prompt.
        The flat pool preserves nothing across admissions."""
        return 0

    def swap_in_bytes(self, rid: int) -> float:
        """Bytes that must cross the host link before ``rid`` can run."""
        return 0.0

    def swap_in(self, rid: int) -> None:
        """Bring ``rid``'s host-tier blocks back into HBM."""
