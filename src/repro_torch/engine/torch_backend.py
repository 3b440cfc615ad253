"""The engines of the port: ``TorchEngine`` (fused continuous batching,
paged or dense KV layout) and ``ReferenceTorchEngine`` (the
slot-sequential oracle), in PyTorch.

Counterparts of the JAX package's ``engine/jax_backend.py``, sharing the
slot bookkeeping of ``_SlotEngineBase`` as there, and speaking the same
backend protocol to ``Replica`` (``on_admit`` / ``on_release`` /
``execute``).

``TorchEngine`` is ``JaxEngine`` with ``attn_impl="pallas"``: one
``fused_serve_forward`` per BatchPlan, with prefill chunks and the decode
batch as per-slot rows bucketed to the engine quantum, Mamba layers'
recurrent state kept per slot, greedy sampling on the device and one
device-to-host transfer per iteration. Its default KV layout is PAGED
(``kv_layout="paged"``): pages granted by the scheduler's ``KVPool``,
block tables rebuilt from its grants, ``kv_quant`` int8 pages with bf16
scale pages, the pool's runtime hooks (``swap_out`` / ``swap_in`` /
``drop``) and the wire hooks (``export_swapped`` / ``import_swapped``)
carrying the KV hierarchy's swap tier and cross-engine transfers on real
pages, and prefix-cache hits as block tables that share pages.
``kv_layout="dense"`` keeps the contiguous ``[n_slots, max_len]`` slot
cache (no pool binding; recompute-only relegation), whose decode reads
are the decode kernel over 256-token pages of it. Mixture-of-experts
layers serve through ``moe_impl``: the grouped GEMM (the default, as
``JaxEngine``'s) or the dropless every-expert sweep. Sliding-window
layers read their window; when every attention layer is sliding-window,
the paged layout returns the leading blocks that slid out of every
window to the pool as they die (SWA page reclamation, as in
``JaxEngine``), counted in ``kv_blocks_reclaimed``.

``TorchEngine(tp=N)`` serves one replica over N ranks, as ``JaxEngine(tp=N)``
does over a mesh (docs/engine.md §Sharded serve): the engine the caller
holds is rank 0 and spawns ranks 1..N-1 (``distributed/worker.py``), each
a process holding its slice of the heads, the dense d_ff, the experts and
the vocab (``distributed/tp_serve.py::TPServePlan``) and its kv-heads of
every cache, and running the same kernels on them; the serve forward's
gathers join the slices before every combine. Rank 0 packs each plan
from the pool and sends the step's host arrays to the other ranks before
it runs the step itself.

``ReferenceTorchEngine`` is ``ReferenceJaxEngine``: one ``prefill`` call
per prefill chunk against its slot, one batched ``decode_step`` over all
slots whose inactive slots do not advance, a host argmax per request,
MoE routed dropless, attention as plain torch ops (the norms and the
SSD scan through ``kernels.ops``, as everywhere). It is the port's
equivalence oracle, and the one engine that serves encoder-decoder
models.

On the card, ``TorchEngine`` replays its decode sub-batch from CUDA
graphs, one captured per page-window rung the first time that rung
decodes, wherever no layer's decode pass reads the host
(``graphs_engage``); the prefill sub-batch runs eagerly after it. Not
ported yet (ROADMAP.md queue 1): the prefill lattice as CUDA graphs.
"""
from __future__ import annotations

import threading
import time
import weakref
from typing import Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.backpressure import EngineBackpressure
from repro_torch.core.kvpool import KVPool, blocks_for
from repro_torch.core.request import Request
from repro_torch.core.scheduler import BatchPlan
from repro_torch.device import resolve_device
from repro_torch.distributed.tp_serve import TPServePlan, pick_backend
from repro_torch.distributed.worker import TPWorkers
from repro_torch.kernels import build, ops
from repro_torch.models import moe
from repro_torch.models.config import ATTN, MAMBA, MOE, SWA, ModelConfig
from repro_torch.models.mamba2 import MambaState
from repro_torch.models.transformer import (MOE_IMPLS, _check_decoder_only,
                                            _identity_shard, decode_step,
                                            fused_serve_forward, init_cache,
                                            init_paged_cache, init_params,
                                            load_params, prefill)
from repro_torch.obs.spans import span

# captures of every engine in the process, one at a time (the async fleet
# steps its engines on threads)
_CAPTURE_LOCK = threading.Lock()


def graphs_engage(cfg: ModelConfig, device: torch.device, tp: int,
                  moe_impl: str) -> bool:
    """Whether ``TorchEngine`` replays its decode sub-batch from CUDA
    graphs: on the card, on one rank, and where no layer's decode pass
    reads the host. The grouped MoE is the one such layer: it reads its
    largest expert segment to pick a capacity rung (``models/moe.py``).
    Mamba, sliding-window, int8-page and dense-layout decode passes read
    nothing back (the card's sync audit, ``PERF.md`` §6)."""
    return (device.type == "cuda" and tp == 1
            and not (moe_impl == "grouped"
                     and any(l.ffn == MOE for l in cfg.layers)))


def _slot_slice(cache: Dict, slot: int) -> Dict:
    """Slot ``slot`` of a dense cache as a one-row cache of views: the
    offline path writes through them into the engine's cache."""
    def view(c):
        return type(c)(*(a[slot:slot + 1] for a in c))
    sub = {"layers": [view(c) for c in cache["layers"]],
           "len": cache["len"][slot:slot + 1]}
    if "cross" in cache:
        sub["cross"] = [view(c) for c in cache["cross"]]
    return sub


class _SlotEngineBase:
    """Host-side slot bookkeeping shared by both engines: the weights,
    slot assignment, synthetic prompt generation (seeded,
    admission-order independent), generated-token streams, the stub
    inputs and iteration logging.

    ``params``: a ``state_dict`` (for example the JAX engine's weights
    through ``bridge.params_from_numpy``), loaded onto ``device`` in
    ``dtype``; without it the weights are drawn from a generator seeded
    with ``seed``. ``device`` defaults to the card and raises when there
    is none. ``shard`` (a tensor-parallel rank's slicing rule, ``(name,
    tensor) -> tensor``) keeps the rank's slice of each weight;
    ``sliced``: ``params`` holds those slices already."""

    def __init__(self, cfg: ModelConfig, n_slots: int = 8,
                 max_len: int = 512, quantum: int = 64, seed: int = 0,
                 dtype=torch.float32,
                 params: Optional[Mapping[str, torch.Tensor]] = None,
                 device="cuda", shard=None, sliced: bool = False):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.n_slots = n_slots
        self.max_len = max_len
        self.quantum = max(1, quantum)
        self.dtype = dtype
        self.seed = seed
        if params is None:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(seed)
            self.params = init_params(cfg, gen, self.device, dtype, shard)
        else:
            self.params = load_params(cfg, params, self.device, dtype, shard,
                                      sliced)
        self.slot_of: Dict[int, int] = {}
        self.free_slots = list(range(n_slots))
        self.tokens: Dict[int, np.ndarray] = {}   # rid -> prompt tokens
        self.generated: Dict[int, List[int]] = {}
        # (plan.cost(), wall seconds) of every executed plan
        self.iteration_log: List[tuple] = []
        self._extras_cache: Dict[int, dict] = {}

    @property
    def jit_compiles(self) -> int:
        """Programs compiled per shape bucket (``JaxEngine``'s count): 0
        here, since eager PyTorch compiles no program per shape;
        ``TorchEngine`` counts the CUDA graphs it captured. The scrape
        does not export it (``obs/scrape.py``)."""
        return 0

    def _gen_tokens(self, req: Request) -> np.ndarray:
        """Synthetic prompt tokens, seeded per rid exactly as the JAX
        engines seed them, so every engine serves the same prompts.
        Requests sharing a ``prefix_id`` share their first
        ``prefix_len`` tokens."""
        vocab = self.cfg.vocab_size
        toks = np.random.default_rng((self.seed, 1, req.rid)).integers(
            0, vocab, size=req.prompt_len).astype(np.int32)
        if req.prefix_id is not None and req.prefix_len > 0:
            n = min(req.prefix_len, req.prompt_len)
            toks[:n] = np.random.default_rng(
                (self.seed, 2, req.prefix_id)).integers(
                0, vocab, size=n).astype(np.int32)
        return toks

    # ------------------------------------------------ backend protocol
    def on_admit(self, req: Request) -> None:
        if req.rid in self.slot_of:
            return
        if not self.free_slots:
            raise EngineBackpressure(
                f"engine slots exhausted admitting rid {req.rid}: all "
                f"{self.n_slots} slots are busy. The scheduler's KV pool "
                f"must mirror slot availability — give it max_seqs == "
                f"n_slots ({self.n_slots}) (paged layout), or size it "
                f"with num_blocks == n_slots and block_size == max_len "
                f"({self.max_len}) (dense layout), so admission control "
                f"cannot admit more concurrent requests than the engine "
                f"has decode rows.",
                kind="slots", n_slots=self.n_slots, rid=req.rid)
        slot = self.free_slots.pop()
        self.slot_of[req.rid] = slot
        if req.rid not in self.tokens:
            self.tokens[req.rid] = self._gen_tokens(req)
            self.generated[req.rid] = []
        self._reset_slot(slot)

    def on_release(self, req: Request) -> None:
        slot = self.slot_of.pop(req.rid, None)
        if slot is not None:
            self.free_slots.append(slot)
            self._release_slot(slot)

    def _reset_slot(self, slot: int) -> None: ...

    def _release_slot(self, slot: int) -> None: ...

    def _lbucket(self, lmax: int) -> int:
        """Chunk-length bucket: the smallest quantum * 2^k >= lmax."""
        if lmax <= 0:
            return 1
        n = -(-lmax // self.quantum)
        p = 1
        while p < n:
            p *= 2
        return self.quantum * p

    def _extras(self, batch_size: int) -> dict:
        """The stubs' inputs, constant zeros in fp32 on the engine's
        device, as JAX builds them: ``frontend_embeds`` [B, num_tokens,
        d] for a vision frontend and ``frames`` [B, num_positions, d]
        for an encoder; built once per batch size."""
        ex = self._extras_cache.get(batch_size)
        if ex is None:
            ex = {}
            if self.cfg.frontend is not None \
                    and self.cfg.frontend.kind == "vision":
                ex["frontend_embeds"] = torch.zeros(
                    (batch_size, self.cfg.frontend.num_tokens,
                     self.cfg.d_model), device=self.device)
            if self.cfg.encoder is not None:
                ex["frames"] = torch.zeros(
                    (batch_size, self.cfg.encoder.num_positions,
                     self.cfg.d_model), device=self.device) * 0.01
            self._extras_cache[batch_size] = ex
        return ex


class TorchEngine(_SlotEngineBase):
    """Fused engine: ``execute`` runs ONE ``fused_serve_forward`` per
    BatchPlan. ``kv_layout="paged"`` (default): attention KV lives in a
    global page pool; the bound ``KVPool`` grants physical block ids and
    the engine rebuilds per-slot block tables from
    ``pool.block_table(rid)`` when a row's grant changed.
    ``kv_layout="dense"``: the contiguous slot cache (``init_cache``; no
    pool binding, ``block_size = max_len``).

    ``kv_quant`` keeps int8 KV pages with bf16 scale pages
    (``QuantPagedAttnCache``; paged layout only, as in JAX).
    ``moe_impl`` is the MoE layers' FFN, ``"grouped"`` or ``"dropless"``
    (``models/moe.py``). ``gather_buckets=False`` pins every block table
    to the full page window (``max_blocks``), as in ``JaxEngine``.
    Refuses encoder-decoder models, as ``JaxEngine`` does. ``params`` and
    ``device``: see ``_SlotEngineBase``.

    ``tp`` > 1 serves the replica over ``tp`` ranks (``TPServePlan``):
    this engine is rank 0, which spawns ranks 1..tp-1 with the same
    arguments (``params``, a full ``state_dict``, is cut here and each
    rank is sent its slices alone; without it every rank draws the
    seeded weights and keeps its slice), joins them in a group over
    ``pick_backend``'s backend (gloo on the CPU or on one shared card,
    NCCL over a card per rank) and sends each step to them. ``tp_group``
    is given only to ranks 1..tp-1, by ``distributed/worker.py``; there
    ``params`` holds the rank's slices already. Every rendezvous,
    collective, reply and join gives up after ``TIMEOUT_S`` seconds, so
    a dead rank fails the caller. ``close()`` stops the ranks (also when
    the engine is collected). ``tp_collective_bytes`` accumulates
    ``TPServePlan.collective_bytes`` per dispatch at JAX's 4 bytes an
    element, as ``JaxEngine``'s counters do. A dim that does not divide
    ``tp`` replicates, and the engine still serves.

    Where ``graphs_engage`` holds, a step with decodes runs them as their
    own pass (``P = 0``) at the page-window rung of the decode rows
    alone, replayed from that rung's CUDA graph over static inputs, and
    then its prefill rows, if any, as an eager pass (``nd = 0``); the
    first decode step at a rung captures it (``_capture``). Counters:
    ``graph_captures``, ``graph_replays`` (decode passes replayed) and
    ``eager_decode_steps`` (steps whose decodes ran eagerly)."""

    def __init__(self, cfg: ModelConfig, n_slots: int = 8,
                 max_len: int = 512, quantum: int = 64, seed: int = 0,
                 dtype=torch.float32, kv_layout: str = "paged",
                 block_size: int = 64, pool: Optional[KVPool] = None,
                 params: Optional[Mapping[str, torch.Tensor]] = None,
                 device="cuda", kv_quant: bool = False,
                 moe_impl: str = "grouped", gather_buckets: bool = True,
                 tp: int = 1, tp_group=None):
        _check_decoder_only(cfg)
        if kv_layout not in ("paged", "dense"):
            raise ValueError(f"unknown kv_layout {kv_layout!r}")
        if moe_impl not in MOE_IMPLS:
            raise ValueError(f"unknown moe_impl {moe_impl!r}; one of "
                             f"{list(MOE_IMPLS)}")
        # read by the fleet runtime's transfer check (AsyncFleet.
        # _compatible), as JaxEngine's: the layout, and the dtype of the
        # weights and pages
        self.paged = kv_layout == "paged"
        if kv_quant and not self.paged:
            raise ValueError(
                "kv_quant rides the paged layout (int8 scale pages share "
                "the block tables); use init_cache(kv_quant=True) for the "
                "dense offline path")
        self.tp = tp
        self.tp_collective_bytes: Dict[str, float] = {}
        self._tp_plan = TPServePlan(cfg, tp) if tp > 1 else None
        # tensor parallelism: this rank's group and gather hooks; rank 0
        # also holds the other ranks (``_tp_workers``), started first so
        # that they build their shards while this one builds its own
        self._tp_group = tp_group
        self._tp_workers = None
        self._shard = _identity_shard
        if tp > 1 and tp_group is None:
            if self.paged and pool is not None:
                block_size = pool.block_size
            self._spawn_ranks(params, resolve_device(device), dict(
                n_slots=n_slots, max_len=max_len, quantum=quantum,
                seed=seed, dtype=dtype, kv_layout=kv_layout,
                block_size=block_size, kv_quant=kv_quant, moe_impl=moe_impl,
                gather_buckets=gather_buckets,
                pool=KVPool(pool.num_blocks if pool is not None
                            else n_slots * (max_len // block_size),
                            block_size, max_seqs=n_slots)
                if self.paged else None))
        shard = None
        if self._tp_plan is not None:
            rank = tp_group.rank if tp_group is not None else 0
            plan = self._tp_plan

            def shard(name, t):
                return plan.shard_param(name, t, rank)
        super().__init__(cfg, n_slots, max_len, quantum, seed, dtype,
                         params, device, shard=shard,
                         sliced=tp_group is not None)
        # the rank's kv-heads size its caches
        cache_cfg = self._tp_plan.local_cfg() if self._tp_plan is not None \
            else cfg
        self.moe_impl = moe_impl
        self.kv_quant = kv_quant
        self.gather_buckets = gather_buckets
        if self.paged:
            if pool is not None:
                block_size = pool.block_size
            if max_len % block_size:
                raise ValueError(f"max_len ({max_len}) must be a multiple "
                                 f"of block_size ({block_size})")
            self.block_size = block_size
            self.max_blocks = max_len // block_size
            self._pool_owned = pool is None
            self.pool = pool if pool is not None else KVPool(
                num_blocks=n_slots * self.max_blocks, block_size=block_size,
                max_seqs=n_slots)
            self.pool.bind_runtime(self)
            self.cache = init_paged_cache(
                cache_cfg, n_slots, self.pool.num_blocks, block_size,
                dtype=dtype, device=self.device, kv_quant=kv_quant)
        else:
            self.block_size = max_len
            self.max_blocks = 1
            self.pool = None
            cache = init_cache(cache_cfg, n_slots, max_len, dtype=dtype,
                               chunk=max_len, device=self.device)
            cache.pop("len")        # lengths are host-side bookkeeping
            self.cache = cache
        # SWA page reclamation, as JaxEngine gates it: paged, and EVERY
        # attention layer sliding-window (block tables are shared across
        # layers, so one full-attention layer pins every page).
        # Positions r <= len - W are outside every window forever, so
        # their blocks return to the pool; the freed table entries are -1
        # holes, which the gather reads as page 0 and the window masks.
        swa_wins = [l.window for l in cfg.layers
                    if l.mixer == SWA and l.window]
        self._swa_reclaim_window = (
            max(swa_wins) if self.paged and swa_wins
            and not any(l.mixer == ATTN for l in cfg.layers) else None)
        self.kv_blocks_reclaimed = 0
        # paged page-window bucket hits: maxb -> iteration count
        self.gather_bucket_hits: Dict[int, int] = {}
        # device block tables reused while no live row's table changed
        # (the pool's table_version stamp is part of the key)
        self._pre_bt_key = self._dec_bt_key = None
        self._pre_bt_dev = self._dec_bt_dev = None
        self._pre_bt_host = self._dec_bt_host = None
        self.slot_len = np.zeros((n_slots,), np.int32)
        self.last_token = np.zeros((n_slots,), np.int32)
        # host-parked state of swapped-out requests, CPU tensors:
        # rid -> {"tokens", "last_token", "pages": {layer: cache fields},
        #         "mamba": {layer: (conv, ssm)}}
        self._swap_store: Dict[int, dict] = {}
        # real prefill work dispatched (prefix-cache hits shrink these)
        self.prefill_rows = 0
        self.prefill_tokens = 0
        # the (P, L, nd[, maxb]) shape buckets that execute has served
        self._buckets: set = set()
        # the decode sub-batch as its own pass over static inputs
        # (``_split``), replayed from CUDA graphs on the card (``_graphs``:
        # rung -> (graph, its sampled ids, its kernel counts)); both
        # private switches are the engagement rule's, flipped only by tests
        # and by chip_smoke.py's TP comparison, which records the hidden
        # states of one fused forward a step
        self._split = graphs_engage(cfg, self.device, tp, moe_impl)
        self._capture = self.device.type == "cuda"
        self._graphs: Dict[int, tuple] = {}
        self._graph_pool = self._graph_stream = None
        self._stage = self._dec_in = None
        self.graph_captures = self.graph_replays = 0
        self.eager_decode_steps = 0
        if self._tp_workers is not None:
            try:
                self._tp_group = self._tp_workers.join_group()
                self._tp_workers.wait_ready()
            except BaseException:
                self.close()
                raise
        if self._tp_plan is not None:
            self._shard = self._tp_plan.shard_fn(self._tp_group)

    # ------------------------------------------------ tensor parallelism
    def _spawn_ranks(self, params, device: torch.device,
                     engine_kw: dict) -> None:
        """Rank 0: start ranks 1..tp-1 with this engine's arguments (each
        rank's slices of ``params`` only, as numpy arrays) on the backend
        ``pick_backend`` names; they build their shards while this rank
        builds its own."""
        from repro_torch import bridge
        backend = pick_backend(device, self.tp)
        plan = self._tp_plan

        def rank_params(rank):
            return None if params is None else \
                bridge.rank_params_to_numpy(params, plan, rank)
        self._tp_workers = TPWorkers(plan.cfg, dict(
            engine_kw, device=str(device)), rank_params, self.tp, backend)
        self._finalizer = weakref.finalize(self, self._tp_workers.close)

    def _mirror(self, name: str, *args) -> None:
        """Rank 0 of a tensor-parallel engine: send the call ``name(*args)``
        to ranks 1..tp-1 before running it here. Elsewhere a no-op."""
        if self._tp_workers is not None:
            self._tp_workers.send(name, args)

    def close(self) -> None:
        """Stop ranks 1..tp-1 and wait for them (idempotent). A no-op at
        tp=1 and on the other ranks."""
        if self._tp_workers is not None:
            self._tp_workers = None
            self._finalizer()

    def rank_stats(self) -> list:
        """Every rank's counters since the last ``reset_rank_stats``, in
        rank order: its kernels' launch and plain-call counts, the
        attention launches by head layout and by variant
        (``kernels.ops``), the MoE capacity rungs it took, the bytes its
        gathers received, by op (``TPGroup.recv_bytes``), and on the card
        its peak device memory since the process began."""
        own = self._rank_stats()
        if self._tp_workers is None:
            return [own]
        return [own] + self._tp_workers.ask("_rank_stats")

    def _rank_stats(self) -> dict:
        cuda = self.device.type == "cuda"
        return {"counts": ops.counts(), "heads": ops.heads(),
                "variants": ops.variants(), "rungs": dict(moe.rungs),
                "recv_bytes": dict(self._tp_group.recv_bytes)
                if self._tp_group is not None else {},
                "peak_device_bytes": torch.cuda.max_memory_allocated(
                    self.device) if cuda else 0}

    def reset_rank_stats(self) -> None:
        """Zero every rank's counters of ``rank_stats`` (not the memory
        readings)."""
        self._mirror("reset_rank_stats")
        ops.reset_counts()
        moe.rungs.clear()
        if self._tp_group is not None:
            self._tp_group.recv_bytes.clear()

    @property
    def buckets_seen(self) -> tuple:
        """Distinct shape buckets served by ``execute``: (prefill rows,
        chunk length, decode rows), and the page-window width for the
        paged layout."""
        return tuple(sorted(self._buckets))

    @property
    def jit_compiles(self) -> int:
        """The CUDA graphs captured: one per page-window rung the decode
        sub-batch has reached, at its first decode step there (not in
        ``warm``); 0 where graphs do not engage, on the CPU among them."""
        return self.graph_captures

    @property
    def prefix_sharing_ok(self) -> bool:
        """Prefix sharing is per KV block; recurrent Mamba state is not a
        per-block quantity, so a family with Mamba layers cannot skip
        prefill through shared pages (as in the JAX engine)."""
        return not any(l.mixer == MAMBA for l in self.cfg.layers)

    # ------------------------------------------------ pool runtime hooks
    # (called by the pool or the hierarchy, so that accounting moves carry
    # real pages; the sink page never travels: tables never name it)
    def swap_out(self, rid: int, block_ids: Sequence[int]) -> None:
        """Copy ``rid``'s private pages (every field of each attention
        layer's cache tuple, so int8 scale pages travel with their pages),
        its slot's Mamba state and its sampling cursor to host memory.
        Called while the request still holds its slot. Every rank parks
        its own kv-heads of the pages."""
        slot = self.slot_of[rid]
        self._park(rid, slot, list(block_ids), int(self.slot_len[slot]),
                   int(self.last_token[slot]))

    def _park(self, rid: int, slot: int, block_ids: list, tokens: int,
              last_token: int) -> None:
        self._mirror("_park", rid, slot, block_ids, tokens, last_token)
        ids = torch.as_tensor(block_ids, dtype=torch.long,
                              device=self.device)
        pages, mamba = {}, {}
        for li, c in enumerate(self.cache["layers"]):
            if isinstance(c, MambaState):
                mamba[li] = (c.conv[slot].to("cpu", copy=True),
                             c.ssm[slot].to("cpu", copy=True))
            else:
                pages[li] = tuple(a[ids].to("cpu") for a in c)
        self._swap_store[rid] = {"tokens": tokens, "last_token": last_token,
                                 "pages": pages, "mamba": mamba}

    def swap_in(self, rid: int, block_ids: Sequence[int]) -> None:
        """Write ``rid``'s saved pages into the freshly granted physical
        blocks ``block_ids``, in place; the slot's state is restored at
        ``on_admit``."""
        self._mirror("swap_in", rid, list(block_ids))
        st = self._swap_store[rid]
        ids = torch.as_tensor(list(block_ids), dtype=torch.long,
                              device=self.device)
        for li, saved in st["pages"].items():
            for a, s in zip(self.cache["layers"][li], saved):
                a.index_copy_(0, ids, s.to(self.device, a.dtype))

    def drop(self, rid: int) -> None:
        self._mirror("drop", rid)
        self._swap_store.pop(rid, None)

    def _unpark(self, rid: int, slot: int) -> dict:
        """Swap-resume into ``slot``: restore the slot's recurrent state
        from ``rid``'s parked entry, which is forgotten; returns it."""
        self._mirror("_unpark", rid, slot)
        st = self._swap_store.pop(rid)
        for li, (conv, ssm) in st["mamba"].items():
            c = self.cache["layers"][li]
            c.conv[slot].copy_(conv)
            c.ssm[slot].copy_(ssm)
        return st

    # ------------------------------------------------ cross-engine wire
    def export_swapped(self, rid: int) -> dict:
        """Detach ``rid``'s host-parked state as a self-contained wire
        payload: the swap-store entry (pages, recurrent state, sampling
        cursor), the prompt tokens and the generated stream. ``swap_out``
        must have run. A tensor-parallel engine gathers every rank's
        kv-heads of the pages, so the payload is a tp=1 engine's."""
        swap = self._swap_store.pop(rid)
        if self._tp_workers is not None:
            shards = self._tp_workers.ask("_pop_parked_pages", rid)
            swap = dict(swap, pages=self._tp_plan.join_pages(
                [swap["pages"], *shards]))
        return {"swap": swap,
                "prompt": self.tokens.pop(rid),
                "generated": self.generated.pop(rid)}

    def _pop_parked_pages(self, rid: int) -> dict:
        return self._swap_store.pop(rid)["pages"]

    def import_swapped(self, rid: int, payload: dict) -> None:
        """Land a wire payload from a peer engine (a JAX engine's through
        ``bridge.swap_payload_from_numpy``): ``rid`` becomes a locally
        swap-parked request, which the swap-resume path (``swap_in`` and
        ``on_admit``) restores into fresh blocks and a slot. Each rank of
        a tensor-parallel engine keeps its kv-heads of the pages."""
        self._land(rid, payload["swap"])
        self.tokens[rid] = payload["prompt"]
        self.generated[rid] = payload["generated"]

    def _land(self, rid: int, swap: dict) -> None:
        self._mirror("_land", rid, swap)
        if self._tp_plan is not None:
            swap = dict(swap, pages=self._tp_plan.shard_pages(
                swap["pages"], self._tp_group.rank))
        self._swap_store[rid] = swap

    # ------------------------------------------------ admission
    def on_admit(self, req: Request) -> None:
        fresh = req.rid not in self.slot_of
        super().on_admit(req)
        if not (fresh and self.paged):
            return
        slot = self.slot_of[req.rid]
        if req.rid in self._swap_store:
            # swap-resume: the pages are back (swap_in); restore the slot's
            # recurrent state and sampling cursor
            st = self._unpark(req.rid, slot)
            self.last_token[slot] = st["last_token"]
            self.slot_len[slot] = st["tokens"]
        else:
            # resident shared prefix pages (a fresh cache hit, or a parked
            # request whose whole resident state was shared) already hold
            # the leading tokens' KV: the slot starts mid-prompt. Any
            # other mismatch keeps slot_len 0, which execute's resume
            # check catches.
            resident = self.pool.resident_tokens(req.rid)
            if resident and req.prefilled == resident:
                self.slot_len[slot] = resident

    # release/admit are host operations: no device work per request
    def _reset_slot(self, slot: int) -> None:
        self.slot_len[slot] = 0

    def _release_slot(self, slot: int) -> None:
        self.slot_len[slot] = 0

    def on_release(self, req: Request) -> None:
        super().on_release(req)
        if self.paged and self._pool_owned:
            # standalone (replica-less) use: the engine owns the pool
            self.pool.release(req.rid)

    def _block_row(self, out_row: np.ndarray, rid: int) -> None:
        ids = self.pool.block_table(rid)
        w = out_row.shape[0]
        out_row[:min(len(ids), w)] = ids[:w]

    def _maxb_ladder(self) -> list:
        """Page-window rungs: every width up to 4, then powers of two,
        then ``max_blocks``; only ``max_blocks`` without
        ``gather_buckets``."""
        if not (self.paged and self.gather_buckets):
            return [self.max_blocks]
        rungs = set(range(1, min(4, self.max_blocks) + 1))
        m = 8
        while m < self.max_blocks:
            rungs.add(m)
            m *= 2
        rungs.add(self.max_blocks)
        return sorted(rungs)

    def _maxb_bucket(self, need: int) -> int:
        """The smallest ladder rung covering the longest live row. A
        narrower table reads the same result: the columns dropped hold
        only positions past every row's query. ``max_blocks`` without
        ``gather_buckets``."""
        if not self.gather_buckets:
            return self.max_blocks
        for m in self._maxb_ladder():
            if m >= need:
                return m
        return self.max_blocks

    def _ensure_resident(self, req: Request) -> None:
        """Admission inside ``execute``: a swap-parked request first pulls
        its pages back through the pool (the hierarchy grants fresh blocks
        and calls ``swap_in``; the replica's own later ``kv.swap_in`` then
        does nothing), then takes a slot."""
        if req.rid in self.slot_of:
            return
        if self.paged and self.pool.swapped_tokens(req.rid) > 0:
            self.pool.swap_in(req.rid)
        self.on_admit(req)

    def _tokens_cached(self, rid: int) -> int:
        """Tokens whose KV will be resident once ``rid`` runs: the live
        slot's length, or the parked state (host tier and shared prefix
        pages)."""
        slot = self.slot_of.get(rid)
        if slot is not None:
            return int(self.slot_len[slot])
        return (self.pool.swapped_tokens(rid)
                + self.pool.resident_tokens(rid))

    def _blocks_needed(self, rid: int, target_tokens: int) -> int:
        """Blocks ``execute`` will grant bringing ``rid`` to
        ``target_tokens`` resident: the host tier's swap-in (as many
        blocks as went out) and any growth past what the swap-in and the
        blocks already held cover."""
        pool = self.pool
        swap_blocks = 0
        if pool.swapped_tokens(rid) > 0:
            host = getattr(pool, "host", None)
            if host is not None:
                swap_blocks = host.held(rid)
        have = pool.covered_blocks(rid) + swap_blocks
        grow = blocks_for(target_tokens, pool.block_size) - have
        return swap_blocks + max(0, grow)

    def preflight(self, plan: BatchPlan) -> None:
        """Dry-run the slot and block allocations ``execute`` would make,
        in its order, and raise a deferrable ``EngineBackpressure`` before
        any state changes when the plan overshoots capacity
        (``n_prefill_fit`` prefill items fit; ``None``: not even the
        decode batch does). The dense layout counts slots only."""
        paged = self.paged
        slots = len(self.free_slots)
        blocks = self.pool.free if paged else 0
        for req in plan.decode:
            if req.rid not in self.slot_of:
                slots -= 1
            if paged:
                blocks -= self._blocks_needed(
                    req.rid, self._tokens_cached(req.rid) + 1)
        num_blocks = self.pool.num_blocks if paged else None
        if slots < 0 or blocks < 0:
            raise EngineBackpressure(
                f"engine cannot hold the decode batch: {len(plan.decode)} "
                f"decodes need more than the free {len(self.free_slots)} "
                f"slots / {self.pool.free if paged else 0} blocks — "
                f"decode growth is never deferrable; size the pool for "
                f"the worst-case decode footprint",
                kind="slots" if slots < 0 else "kv", n_prefill_fit=None,
                n_slots=self.n_slots, num_blocks=num_blocks,
                block_size=self.block_size)
        fit = 0
        for req, chunk in plan.prefill:
            take = min(chunk, req.prompt_len - req.prefilled)
            need_slot = 1 if req.rid not in self.slot_of else 0
            need_blocks = self._blocks_needed(
                req.rid, req.prefilled + take) if paged else 0
            if slots - need_slot < 0 or blocks - need_blocks < 0:
                raise EngineBackpressure(
                    f"engine backpressure: prefill item {fit} (rid "
                    f"{req.rid}) does not fit — {slots} slots / {blocks} "
                    f"blocks left of n_slots={self.n_slots}, num_blocks="
                    f"{num_blocks}; defer the prefill tail and retry",
                    kind="slots" if slots - need_slot < 0 else "kv",
                    n_prefill_fit=fit, n_slots=self.n_slots,
                    num_blocks=num_blocks, block_size=self.block_size,
                    rid=req.rid)
            slots -= need_slot
            blocks -= need_blocks
            fit += 1

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    def _step(self, rows: tuple, bts_host: tuple,
              bts: Optional[tuple] = None) -> torch.Tensor:
        """One ``fused_serve_forward`` over the packed host arrays ``rows``
        (pre_tokens, pre_slots, pre_start, pre_len, pre_reset,
        pre_sample_col, dec_tokens, dec_start, dec_active) and the block
        tables (None in the dense layout): ``bts`` on the device where
        the caller holds them, else ``bts_host`` moved there. Rank 0 of a
        tensor-parallel engine sends the same host arrays to the other
        ranks first, and every rank runs the step on its shard."""
        self._mirror("_step", rows, bts_host)
        if bts is None:
            bts = tuple(None if b is None else self._dev(b)
                        for b in bts_host)
        return fused_serve_forward(
            self.params, self.cfg, self.cache, *map(self._dev, rows), *bts,
            self.moe_impl, self._shard)

    def warm(self, max_chunk: Optional[int] = None) -> int:
        """Build and load the kernels (on the card), and launch each once
        with a state-safe iteration: one pad prefill row on the sink row
        and an inactive decode batch, with empty block tables in the
        paged layout, so every write goes to the sink page or row and no
        live slot's state moves. Both sub-batches run every layer's FFN,
        the MoE ones through ``moe_impl``. Returns the calls made (1).

        ``max_chunk`` caps the chunk lengths of ``JaxEngine.warm``'s
        (P, L, nd, maxb) lattice; it is accepted and unused here. Nothing
        is captured here: the decode sub-batch's CUDA graph of a rung is
        captured at the first decode step that reaches the rung, as JAX
        compiles a program on first sight, and the prefill lattice is not
        captured (ROADMAP queue 1 item 2)."""
        if self.device.type == "cuda":
            build.build()
        n = self.n_slots
        q = self.quantum
        z1 = np.zeros((1,), np.int32)
        bts = (None, None)
        if self.paged:
            bts = (np.full((1, 1), -1, np.int32),
                   np.full((n, 1), -1, np.int32))
        self._step((np.zeros((1, q), np.int32), np.full((1,), n, np.int32),
                    z1, z1, np.zeros((1,), bool), z1, self.last_token.copy(),
                    self.slot_len.copy(), np.zeros((n,), bool)), bts)
        return 1

    def execute(self, plan: BatchPlan, now: float) -> float:
        t0 = time.perf_counter()
        with span("engine.pack"):
            self.preflight(plan)
            n = self.n_slots
            # ---- pack the plan (host-side numpy; no device ops)
            pre: List[tuple] = []       # (slot, req, toks)
            for req, chunk in plan.prefill:
                self._ensure_resident(req)
                slot = self.slot_of[req.rid]
                toks = self.tokens[req.rid][
                    req.prefilled:req.prefilled + chunk]
                if req.prefilled != self.slot_len[slot]:
                    raise RuntimeError(
                        f"rid {req.rid} resumes prefill at {req.prefilled} "
                        f"but slot {slot} holds {self.slot_len[slot]} "
                        f"tokens — a state-preserving resume needs the "
                        f"paged engine with a KV hierarchy (the dense "
                        f"layout is flat-KVPool recompute semantics only)")
                if req.prefilled + len(toks) > self.max_len:
                    raise RuntimeError(
                        f"rid {req.rid} prefill would exceed max_len "
                        f"{self.max_len}; size prompts+decodes to the cache")
                if self.paged and not self.pool.grow(
                        req.rid, req.prefilled + len(toks)):
                    raise EngineBackpressure(
                        f"KV pool exhausted growing rid {req.rid} to "
                        f"{req.prefilled + len(toks)} tokens — the "
                        "scheduler admitted beyond pool capacity",
                        kind="kv", num_blocks=self.pool.num_blocks,
                        block_size=self.block_size, rid=req.rid)
                pre.append((slot, req, toks))
            if pre:
                P = 1
                while P < len(pre):
                    P *= 2
                L = self._lbucket(max(len(t) for _, _, t in pre))
            else:
                P, L = 0, 1     # decode-only: the prefill branch is skipped
            pre_tokens = np.zeros((P, L), np.int32)
            pre_slots = np.full((P,), n, np.int32)      # n: the sink row
            pre_start = np.zeros((P,), np.int32)
            pre_len = np.zeros((P,), np.int32)
            pre_reset = np.zeros((P,), bool)
            pre_sample = np.zeros((P,), np.int32)
            emit_pre: List[Optional[int]] = [None] * P
            for i, (slot, req, toks) in enumerate(pre):
                real = len(toks)
                pre_tokens[i, :real] = toks
                pre_slots[i] = slot
                pre_start[i] = req.prefilled
                pre_len[i] = real
                pre_reset[i] = req.prefilled == 0
                if req.prefilled + real >= req.prompt_len:
                    # the last chunk emits the request's first output token
                    pre_sample[i] = real - 1
                    emit_pre[i] = req.rid
            # decode sub-batch: absent (size 0) when the plan has no decodes
            nd = n if plan.decode else 0
            dec_active = np.zeros((nd,), bool)
            emit_dec: List[Optional[int]] = [None] * nd
            for req in plan.decode:
                self._ensure_resident(req)   # mid-decode swap-resume (paged)
                slot = self.slot_of[req.rid]
                if self.slot_len[slot] + 1 > self.max_len:
                    raise RuntimeError(
                        f"rid {req.rid} decode would exceed max_len "
                        f"{self.max_len}; size prompts+decodes to the cache")
                if self.paged and not self.pool.grow(
                        req.rid, int(self.slot_len[slot]) + 1):
                    raise EngineBackpressure(
                        f"KV pool exhausted on decode growth of rid "
                        f"{req.rid}: admission control bounds prefill, not "
                        f"decode growth — size the pool for the worst-case "
                        f"decode footprint (num_blocks >= max_seqs * "
                        f"max_len/block_size)",
                        kind="kv", num_blocks=self.pool.num_blocks,
                        block_size=self.block_size, rid=req.rid)
                dec_active[slot] = True
                emit_dec[slot] = req.rid

            bts = bts_host = (None, None)
            if self.paged:
                bts = self._block_tables(pre, P, nd, emit_dec)
                bts_host = self._bts_host
        # ---- ONE forward (or the decode pass, then the prefill pass);
        # the cache's pages and state written in place
        pre_rows = (pre_tokens, pre_slots, pre_start, pre_len, pre_reset,
                    pre_sample)
        with span("engine.launch"):
            if self._split and nd:
                sampled = self._split_step(pre_rows, dec_active, bts[0])
            else:
                self.eager_decode_steps += int(nd > 0)
                sampled = self._step((*pre_rows, self.last_token[:nd].copy(),
                                      self.slot_len[:nd].copy(), dec_active),
                                     bts_host, bts)
        with span("engine.sync"):
            out = sampled.cpu().numpy()   # the ONE device->host transfer
        with span("engine.post"):
            self._buckets.add((P, L, nd, bts[0].shape[1]) if self.paged
                              else (P, L, nd))
            self.prefill_rows += len(pre)
            self.prefill_tokens += sum(len(t) for _, _, t in pre)
            if self._tp_plan is not None:
                # the gathers' traffic of this dispatch, by op, priced as
                # JaxEngine prices it (real tokens, 4 bytes an element);
                # exported as repro_tp_collective_bytes_total{op=}
                n_tok = sum(len(t) for _, _, t in pre) + int(dec_active.sum())
                for op, b in self._tp_plan.collective_bytes(
                        n_tok, P + nd).items():
                    self.tp_collective_bytes[op] = \
                        self.tp_collective_bytes.get(op, 0.0) + b

            # ---- host bookkeeping
            for slot, req, toks in pre:
                self.slot_len[slot] = req.prefilled + len(toks)
            for i, rid in enumerate(emit_pre):
                if rid is None:
                    continue
                tok = int(out[i])
                self.generated[rid].append(tok)
                self.last_token[pre[i][0]] = tok
            for slot, rid in enumerate(emit_dec):
                if rid is None:
                    continue
                tok = int(out[P + slot])
                self.generated[rid].append(tok)
                self.last_token[slot] = tok
                self.slot_len[slot] += 1
            # ---- SWA page reclamation: the fully dead leading blocks of
            # every live row (positions r <= len - W) go back to the pool
            if self._swa_reclaim_window is not None:
                W = self._swa_reclaim_window
                live = [(req.rid, slot) for slot, req, _ in pre]
                live += [(rid, slot) for slot, rid in enumerate(emit_dec)
                         if rid is not None]
                for rid, slot in live:
                    dead = ((int(self.slot_len[slot]) - W + 1)
                            // self.block_size)
                    if dead > 0:
                        self.kv_blocks_reclaimed += \
                            self.pool.reclaim_prefix(rid, dead)
            elapsed = time.perf_counter() - t0
        self.iteration_log.append((plan.cost(), elapsed))
        return elapsed

    def _block_tables(self, pre, P: int, nd: int, emit_dec) -> tuple:
        """The paged layout's block tables of an iteration, on the
        device, sliced to the page-window bucket covering the longest
        live row; rebuilt only when a row's grant changed. The host
        arrays they came from are left in ``_bts_host``. Where the decode
        sub-batch is its own pass (``_split``), its table covers the
        decode rows alone and stays on the host, for ``_stage_decode``:
        a table widened by empty columns reads the same result
        (``plan_splits``), so the narrower rung is exact."""
        need_pre = need_dec = 1
        for _, req, toks in pre:
            need_pre = max(need_pre, blocks_for(req.prefilled + len(toks),
                                                self.block_size))
        for slot, rid in enumerate(emit_dec):
            if rid is not None:
                need_dec = max(need_dec, blocks_for(
                    int(self.slot_len[slot]) + 1, self.block_size))
        maxb = self._maxb_bucket(max(need_pre, need_dec))
        self.gather_bucket_hits[maxb] = \
            self.gather_bucket_hits.get(maxb, 0) + 1
        ver = self.pool.table_version
        pre_key = (P, maxb, tuple((req.rid, ver(req.rid))
                                  for _, req, _ in pre))
        if pre_key != self._pre_bt_key:
            pre_bt = np.full((P, maxb), -1, np.int32)
            for i, (_, req, _) in enumerate(pre):
                self._block_row(pre_bt[i], req.rid)
            self._pre_bt_dev = self._dev(pre_bt)
            self._pre_bt_host = pre_bt
            self._pre_bt_key = pre_key
        dec_maxb = self._maxb_bucket(need_dec) if self._split else maxb
        dec_key = (nd, dec_maxb, tuple((rid, ver(rid)) if rid is not None
                                       else None for rid in emit_dec))
        if dec_key != self._dec_bt_key:
            dec_bt = np.full((nd, dec_maxb), -1, np.int32)
            for slot, rid in enumerate(emit_dec):
                if rid is not None:
                    self._block_row(dec_bt[slot], rid)
            self._dec_bt_dev = None if self._split else self._dev(dec_bt)
            self._dec_bt_host = dec_bt
            self._dec_bt_key = dec_key
        self._bts_host = (self._pre_bt_host, self._dec_bt_host)
        return self._pre_bt_dev, self._dec_bt_dev

    # ------------------------------------------------ the decode pass
    def _split_step(self, pre_rows: tuple, dec_active: np.ndarray,
                    pre_bt) -> torch.Tensor:
        """A step with decodes where the decode sub-batch is its own
        pass: every copy to the device first (a pageable copy waits for
        the stream, so after a replay it would hold the host behind the
        card), then the decode pass at its rung, replayed from the rung's
        CUDA graph (captured here on the rung's first step) or run
        eagerly where nothing is captured, then the prefill rows, if any,
        as an eager pass with no decode rows, whose launches overlap the
        card's decode work. Returns the sampled ids, prefill rows then
        decode slots."""
        P = pre_rows[0].shape[0]
        if P:
            pre = [self._dev(a) for a in pre_rows]
        maxb = self._dec_bt_host.shape[1] if self.paged else 1
        captured = self._graphs.get(maxb)
        if captured is None and self._capture:
            with span("engine.capture"):
                captured = self._capture_rung(maxb)
        self._stage_decode(dec_active, maxb)
        if captured is None:
            dec = self._decode_forward(maxb)
            self.eager_decode_steps += 1
        else:
            graph, dec, tally = captured
            with span("engine.replay"):
                graph.replay()
            ops.add_tally(tally)
            self.graph_replays += 1
        if not P:
            return dec
        none = torch.zeros((0,), dtype=torch.int32, device=self.device)
        ids = fused_serve_forward(self.params, self.cfg, self.cache, *pre,
                                  none, none, none.bool(), pre_bt, None,
                                  self.moe_impl, self._shard)
        return torch.cat([ids, dec])

    def _decode_inputs(self) -> tuple:
        """The decode pass's static inputs, made on first use: one int32
        buffer on the device that every rung's pass reads (tokens [n],
        start [n], active [n], then the block table [n, maxb] row by row
        at the rung's width, paged layout only) and its host staging
        copy, pinned on the card."""
        if self._dec_in is None:
            n = self.n_slots
            size = 3 * n + (n * self.max_blocks if self.paged else 0)
            self._stage = torch.zeros(size, dtype=torch.int32,
                                      pin_memory=self.device.type == "cuda")
            self._dec_in = torch.zeros(size, dtype=torch.int32,
                                       device=self.device)
        return self._stage, self._dec_in

    def _stage_decode(self, dec_active: np.ndarray, maxb: int) -> None:
        """This step's decode inputs into the static buffer, through the
        staging copy in one asynchronous copy. The step's own read of its
        sampled ids orders the next step's reuse of the staging copy."""
        stage, dev = self._decode_inputs()
        n = self.n_slots
        host = stage.numpy()
        host[:n] = self.last_token
        host[n:2 * n] = self.slot_len
        host[2 * n:3 * n] = dec_active
        k = 3 * n
        if self.paged:
            host[k:k + n * maxb] = self._dec_bt_host.reshape(-1)
            k += n * maxb
        dev[:k].copy_(stage[:k], non_blocking=True)

    def _decode_forward(self, maxb: int) -> torch.Tensor:
        """The decode sub-batch alone (``P = 0``) over the static inputs,
        at rung ``maxb``: the sampled ids [n]."""
        n = self.n_slots
        _, buf = self._decode_inputs()
        bt = buf[3 * n:3 * n + n * maxb].view(n, maxb) if self.paged \
            else None
        none = torch.zeros((0,), dtype=torch.int32, device=self.device)
        return fused_serve_forward(
            self.params, self.cfg, self.cache, none.view(0, 1), none, none,
            none, none.bool(), none, buf[:n], buf[n:2 * n],
            buf[2 * n:3 * n] != 0,
            none.view(0, maxb) if self.paged else None, bt, self.moe_impl,
            self._shard)

    def _capture_rung(self, maxb: int) -> tuple:
        """Capture the decode pass at rung ``maxb`` as a CUDA graph in the
        engine's one graph pool, on its own stream, in the thread-local
        mode (the async fleet steps engines on threads). The warm-up run
        and the capture read an inert batch, no row active and every
        table entry -1, as ``warm`` does: every write lands on the sink
        page or row and no live page or state moves. The kernel counts
        this thread adds in the two (``ops.recording``, so no other
        engine's launches) are taken back; each replay adds those of one
        pass. Returns (graph, its sampled ids, its counts)."""
        n = self.n_slots
        _, buf = self._decode_inputs()
        with _CAPTURE_LOCK, torch.cuda.device(self.device):
            if self._graph_pool is None:
                self._graph_pool = torch.cuda.graph_pool_handle()
                self._graph_stream = torch.cuda.Stream(self.device)
            buf.zero_()
            buf[3 * n:].fill_(-1)
            side, main = self._graph_stream, torch.cuda.current_stream()
            side.wait_stream(main)
            with torch.cuda.stream(side):
                # lazy set-up (cuBLAS's workspace of this stream) outside
                # the capture
                with ops.recording() as warmed:
                    self._decode_forward(maxb)
                graph = torch.cuda.CUDAGraph()
                with ops.recording() as counts, torch.cuda.graph(
                        graph, pool=self._graph_pool, stream=side,
                        capture_error_mode="thread_local"):
                    out = self._decode_forward(maxb)
            main.wait_stream(side)
        ops.add_tally(warmed + counts, -1)
        self._graphs[maxb] = (graph, out, counts)
        self.graph_captures += 1
        return self._graphs[maxb]


class ReferenceTorchEngine(_SlotEngineBase):
    """Slot-sequential oracle, as ``ReferenceJaxEngine``: each prefill
    chunk is one ``prefill`` call against its slot (its rows of the dense
    cache, written in place), decodes run as one batched ``decode_step``
    over all slots in which inactive slots neither write nor advance (the
    in-place form of JAX's post-step select). Chunks are padded to the
    quantum bucket; the pad tokens land past the true length, which is
    set back explicitly, and do not advance Mamba state (``seq_lens``).
    Slower by design: kept as the equivalence reference. ``params`` and
    ``device``: see ``_SlotEngineBase``."""

    def __init__(self, cfg: ModelConfig, n_slots: int = 8,
                 max_len: int = 512, quantum: int = 64, seed: int = 0,
                 dtype=torch.float32,
                 params: Optional[Mapping[str, torch.Tensor]] = None,
                 device="cuda"):
        super().__init__(cfg, n_slots, max_len, quantum, seed, dtype,
                         params, device)
        self.cache = init_cache(cfg, n_slots, max_len, dtype=dtype,
                                chunk=max_len, device=self.device)
        self._last_token = np.zeros((n_slots,), np.int32)
        self._has_mamba = any(l.mixer == MAMBA for l in cfg.layers)

    def _prefill_slot(self, tokens: np.ndarray, slot: int, start: int,
                      real: int, extras: dict) -> torch.Tensor:
        """One chunk ([1, S]) through ``prefill`` on slot ``slot``;
        ``real`` tokens of it are the request's, the rest quantum
        padding. Returns the logits [1, S, Vp]."""
        i32 = dict(dtype=torch.int32, device=self.device)
        logits, _ = prefill(
            self.params, self.cfg, _slot_slice(self.cache, slot),
            torch.as_tensor(tokens, **i32)[None],
            torch.tensor([start], **i32), batch_extras=extras,
            seq_lens=torch.tensor([real], **i32))
        return logits

    def _decode_all(self, active: np.ndarray) -> torch.Tensor:
        """One decode step over every slot from its last token; only the
        ``active`` slots advance. Returns the logits [n_slots, Vp]."""
        logits, _ = decode_step(
            self.params, self.cfg, self.cache,
            torch.as_tensor(self._last_token, device=self.device)[:, None],
            active=torch.as_tensor(active, device=self.device))
        return logits[:, 0]

    def _reset_slot(self, slot: int) -> None:
        # Mamba recurrences are not masked by cache positions the way
        # attention KV is: a reused slot must not leak the previous
        # occupant's state
        if not self._has_mamba:
            return
        for st in self.cache["layers"]:
            if isinstance(st, MambaState):
                st.conv[slot] = 0.0
                st.ssm[slot] = 0.0

    def _release_slot(self, slot: int) -> None:
        # reset the slot's length so stale cache rows cannot leak
        self.cache["len"][slot] = 0

    def warm(self, max_chunk: Optional[int] = None) -> int:
        """Build and load the kernels (on the card), then run one
        prefill chunk of ``quantum`` tokens through slot 0 (its writes
        land below length 0 and are overwritten before they become
        visible; its recurrent state is zeroed again) and one decode step
        with no slot active. Returns the calls made (2). ``max_chunk``
        caps the chunk shapes ``ReferenceJaxEngine.warm`` compiles; eager
        PyTorch compiles nothing per shape, so one call of each is the
        whole warm-up and ``max_chunk`` is accepted and unused."""
        if self.device.type == "cuda":
            build.build()
        L = self._lbucket(1)
        self._prefill_slot(np.zeros((L,), np.int32), 0, 0, L,
                           self._extras(1))
        self.cache["len"][0] = 0
        self._reset_slot(0)
        self._decode_all(np.zeros((self.n_slots,), bool))
        return 2

    def execute(self, plan: BatchPlan, now: float) -> float:
        t0 = time.perf_counter()
        # --- prefill chunks (per request, quantum-bucketed lengths)
        for req, chunk in plan.prefill:
            if req.rid not in self.slot_of:
                self.on_admit(req)
            slot = self.slot_of[req.rid]
            toks = self.tokens[req.rid][req.prefilled:req.prefilled + chunk]
            real = len(toks)
            pad = self._lbucket(real) - real if self.quantum > 1 else 0
            if pad:
                toks = np.concatenate([toks, np.zeros(pad, np.int32)])
            logits = self._prefill_slot(toks, slot, req.prefilled, real,
                                        self._extras(1))
            if pad:
                # padded tail tokens land in positions the NEXT write
                # overwrites; track the TRUE length explicitly
                self.cache["len"][slot] = req.prefilled + real
            if req.prefilled + chunk >= req.prompt_len:
                tok = int(torch.argmax(
                    logits[0, real - 1, :self.cfg.vocab_size]))
                self._last_token[slot] = tok
                self.generated[req.rid].append(tok)
        # --- one batched decode step over all slots, actives advance
        if plan.decode:
            active = np.zeros((self.n_slots,), bool)
            for req in plan.decode:
                active[self.slot_of[req.rid]] = True
            logits = self._decode_all(active)
            toks = torch.argmax(logits[:, :self.cfg.vocab_size],
                                dim=-1).cpu().numpy().astype(np.int32)
            for req in plan.decode:
                slot = self.slot_of[req.rid]
                self._last_token[slot] = toks[slot]
                self.generated[req.rid].append(int(toks[slot]))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)   # honest wall time
        elapsed = time.perf_counter() - t0
        self.iteration_log.append((plan.cost(), elapsed))
        return elapsed


ENGINES = {"fused": TorchEngine, "reference": ReferenceTorchEngine}


def make_engine(kind: str, cfg: ModelConfig, **kw):
    """Engine factory for drivers: ``"fused"`` or ``"reference"``."""
    if kind not in ENGINES:
        raise KeyError(f"unknown engine {kind!r}; known: {list(ENGINES)}")
    return ENGINES[kind](cfg, **kw)
