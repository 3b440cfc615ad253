"""``TorchEngine``: the fused continuous-batching engine on the paged KV
layout, in PyTorch.

The counterpart of the JAX package's ``engine/jax_backend.py::JaxEngine``
with ``kv_layout="paged"``, carrying the slot bookkeeping of its
``_SlotEngineBase``. It speaks the same backend protocol to ``Replica``
(``on_admit`` / ``on_release`` / ``preflight`` / ``execute``): one
``fused_serve_forward`` per BatchPlan, with prefill chunks and the decode
batch as per-slot rows bucketed to the engine quantum, block tables
rebuilt from the scheduler's ``KVPool`` grants, Mamba layers' recurrent
state kept per slot, greedy sampling on the device and one
device-to-host transfer per iteration. ``kv_quant`` stores int8 pages
with bf16 scale pages. The pool's runtime hooks (``swap_out`` /
``swap_in`` / ``drop``) and the wire hooks (``export_swapped`` /
``import_swapped``) carry the KV hierarchy's swap tier and cross-engine
transfers on real pages; prefix-cache hits are block tables that share
pages.

Mixture-of-experts layers serve through ``moe_impl``: the grouped GEMM
(the default, as ``JaxEngine``'s) or the dropless every-expert sweep.
Sliding-window layers read their window of the pages; when every
attention layer is sliding-window, the leading blocks that slid out of
every window return to the pool as they die (SWA page reclamation, as in
``JaxEngine``), counted in ``kv_blocks_reclaimed``.

Not ported yet (ROADMAP.md queue 1): the dense layout, tensor
parallelism and CUDA graphs.
"""
from __future__ import annotations

import time
from typing import Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.backpressure import EngineBackpressure
from repro_torch.core.kvpool import KVPool, blocks_for
from repro_torch.core.request import Request
from repro_torch.core.scheduler import BatchPlan
from repro_torch.device import resolve_device
from repro_torch.kernels import build
from repro_torch.models.config import ATTN, MAMBA, SWA, ModelConfig
from repro_torch.models.mamba2 import MambaState
from repro_torch.models.transformer import (MOE_IMPLS, Transformer,
                                            fused_serve_forward,
                                            init_paged_cache, init_params)


class TorchEngine:
    """Fused engine over a global page pool: the bound ``KVPool`` grants
    physical block ids and the engine rebuilds per-slot block tables
    from ``pool.block_table(rid)`` when a row's grant changed.

    ``params``: a ``state_dict`` (for example the JAX engine's weights
    through ``bridge.params_from_numpy``), loaded onto ``device`` in
    ``dtype``; without it the weights are drawn from a generator seeded
    with ``seed``. ``kv_quant`` keeps int8 KV pages with bf16 scale
    pages (``QuantPagedAttnCache``). ``moe_impl`` is the MoE layers'
    FFN, ``"grouped"`` or ``"dropless"`` (``models/moe.py``). ``device``
    defaults to the card and raises when there is none."""

    def __init__(self, cfg: ModelConfig, n_slots: int = 8,
                 max_len: int = 512, quantum: int = 64, seed: int = 0,
                 dtype=torch.float32, block_size: int = 64,
                 pool: Optional[KVPool] = None,
                 params: Optional[Mapping[str, torch.Tensor]] = None,
                 device="cuda", kv_quant: bool = False,
                 moe_impl: str = "grouped"):
        if moe_impl not in MOE_IMPLS:
            raise ValueError(f"unknown moe_impl {moe_impl!r}; one of "
                             f"{list(MOE_IMPLS)}")
        self.device = resolve_device(device)
        self.moe_impl = moe_impl
        self.cfg = cfg
        self.n_slots = n_slots
        self.max_len = max_len
        self.quantum = max(1, quantum)
        self.seed = seed
        # read by the fleet runtime's transfer check (AsyncFleet.
        # _compatible), as JaxEngine's: this engine is always paged, and
        # its weights and pages are in ``dtype``
        self.paged = True
        self.dtype = dtype
        if params is None:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(seed)
            self.params = init_params(cfg, gen, self.device, dtype)
        else:
            self.params = Transformer(cfg, self.device, dtype)
            self.params.load_state_dict(params, strict=True)
        self.slot_of: Dict[int, int] = {}
        self.free_slots = list(range(n_slots))
        self.tokens: Dict[int, np.ndarray] = {}   # rid -> prompt tokens
        self.generated: Dict[int, List[int]] = {}

        if pool is not None:
            block_size = pool.block_size
        if max_len % block_size:
            raise ValueError(f"max_len ({max_len}) must be a multiple of "
                             f"block_size ({block_size})")
        self.block_size = block_size
        self.max_blocks = max_len // block_size
        self._pool_owned = pool is None
        self.pool = pool if pool is not None else KVPool(
            num_blocks=n_slots * self.max_blocks, block_size=block_size,
            max_seqs=n_slots)
        self.pool.bind_runtime(self)
        self.kv_quant = kv_quant
        self.cache = init_paged_cache(cfg, n_slots, self.pool.num_blocks,
                                      block_size, dtype=dtype,
                                      device=self.device, kv_quant=kv_quant)
        # SWA page reclamation, as JaxEngine gates it: only when EVERY
        # attention layer is sliding-window (block tables are shared
        # across layers, so one full-attention layer pins every page).
        # Positions r <= len - W are outside every window forever, so
        # their blocks return to the pool; the freed table entries are -1
        # holes, which the gather reads as page 0 and the window masks.
        swa_wins = [l.window for l in cfg.layers
                    if l.mixer == SWA and l.window]
        self._swa_reclaim_window = (
            max(swa_wins) if swa_wins
            and not any(l.mixer == ATTN for l in cfg.layers) else None)
        self.kv_blocks_reclaimed = 0
        # paged page-window bucket hits: maxb -> iteration count
        self.gather_bucket_hits: Dict[int, int] = {}
        # device block tables reused while no live row's table changed
        # (the pool's table_version stamp is part of the key)
        self._pre_bt_key = self._dec_bt_key = None
        self._pre_bt_dev = self._dec_bt_dev = None
        self.slot_len = np.zeros((n_slots,), np.int32)
        self.last_token = np.zeros((n_slots,), np.int32)
        # host-parked state of swapped-out requests, CPU tensors:
        # rid -> {"tokens", "last_token", "pages": {layer: cache fields},
        #         "mamba": {layer: (conv, ssm)}}
        self._swap_store: Dict[int, dict] = {}
        # real prefill work dispatched (prefix-cache hits shrink these)
        self.prefill_rows = 0
        self.prefill_tokens = 0
        # (plan.cost(), wall seconds) of every executed plan, as JaxEngine
        # keeps it
        self.iteration_log: List[tuple] = []
        # the (P, L, nd, maxb) shape buckets that execute has served
        self._buckets: set = set()

    @property
    def buckets_seen(self) -> tuple:
        """Distinct shape buckets served by ``execute``: (prefill rows,
        chunk length, decode rows, page-window width)."""
        return tuple(sorted(self._buckets))

    @property
    def prefix_sharing_ok(self) -> bool:
        """Prefix sharing is per KV block; recurrent Mamba state is not a
        per-block quantity, so a family with Mamba layers cannot skip
        prefill through shared pages (as in the JAX engine)."""
        return not any(l.mixer == MAMBA for l in self.cfg.layers)

    def _gen_tokens(self, req: Request) -> np.ndarray:
        """Synthetic prompt tokens, seeded per rid exactly as the JAX
        engine seeds them, so both engines serve the same prompts."""
        vocab = self.cfg.vocab_size
        toks = np.random.default_rng((self.seed, 1, req.rid)).integers(
            0, vocab, size=req.prompt_len).astype(np.int32)
        if req.prefix_id is not None and req.prefix_len > 0:
            n = min(req.prefix_len, req.prompt_len)
            toks[:n] = np.random.default_rng(
                (self.seed, 2, req.prefix_id)).integers(
                0, vocab, size=n).astype(np.int32)
        return toks

    # ------------------------------------------------ pool runtime hooks
    # (called by the pool or the hierarchy, so that accounting moves carry
    # real pages; the sink page never travels: tables never name it)
    def swap_out(self, rid: int, block_ids: Sequence[int]) -> None:
        """Copy ``rid``'s private pages (every field of each attention
        layer's cache tuple, so int8 scale pages travel with their pages),
        its slot's Mamba state and its sampling cursor to host memory.
        Called while the request still holds its slot."""
        slot = self.slot_of[rid]
        ids = torch.as_tensor(list(block_ids), dtype=torch.long,
                              device=self.device)
        pages, mamba = {}, {}
        for li, c in enumerate(self.cache["layers"]):
            if isinstance(c, MambaState):
                mamba[li] = (c.conv[slot].to("cpu", copy=True),
                             c.ssm[slot].to("cpu", copy=True))
            else:
                pages[li] = tuple(a[ids].to("cpu") for a in c)
        self._swap_store[rid] = {
            "tokens": int(self.slot_len[slot]),
            "last_token": int(self.last_token[slot]),
            "pages": pages, "mamba": mamba}

    def swap_in(self, rid: int, block_ids: Sequence[int]) -> None:
        """Write ``rid``'s saved pages into the freshly granted physical
        blocks ``block_ids``, in place; the slot's state is restored at
        ``on_admit``."""
        st = self._swap_store[rid]
        ids = torch.as_tensor(list(block_ids), dtype=torch.long,
                              device=self.device)
        for li, saved in st["pages"].items():
            for a, s in zip(self.cache["layers"][li], saved):
                a.index_copy_(0, ids, s.to(self.device, a.dtype))

    def drop(self, rid: int) -> None:
        self._swap_store.pop(rid, None)

    # ------------------------------------------------ cross-engine wire
    def export_swapped(self, rid: int) -> dict:
        """Detach ``rid``'s host-parked state as a self-contained wire
        payload: the swap-store entry (pages, recurrent state, sampling
        cursor), the prompt tokens and the generated stream. ``swap_out``
        must have run."""
        return {"swap": self._swap_store.pop(rid),
                "prompt": self.tokens.pop(rid),
                "generated": self.generated.pop(rid)}

    def import_swapped(self, rid: int, payload: dict) -> None:
        """Land a wire payload from a peer engine (a JAX engine's through
        ``bridge.swap_payload_from_numpy``): ``rid`` becomes a locally
        swap-parked request, which the swap-resume path (``swap_in`` and
        ``on_admit``) restores into fresh blocks and a slot."""
        self._swap_store[rid] = payload["swap"]
        self.tokens[rid] = payload["prompt"]
        self.generated[rid] = payload["generated"]

    # ------------------------------------------------ backend protocol
    def on_admit(self, req: Request) -> None:
        if req.rid in self.slot_of:
            return
        if not self.free_slots:
            raise EngineBackpressure(
                f"engine slots exhausted admitting rid {req.rid}: all "
                f"{self.n_slots} slots are busy. Give the scheduler's KV "
                f"pool max_seqs == n_slots ({self.n_slots}) so admission "
                f"control cannot admit more concurrent requests than the "
                f"engine has decode rows.",
                kind="slots", n_slots=self.n_slots, rid=req.rid)
        slot = self.free_slots.pop()
        self.slot_of[req.rid] = slot
        if req.rid not in self.tokens:
            self.tokens[req.rid] = self._gen_tokens(req)
            self.generated[req.rid] = []
        self.slot_len[slot] = 0
        st = self._swap_store.pop(req.rid, None)
        if st is not None:
            # swap-resume: the pages are back (swap_in); restore the slot's
            # recurrent state and sampling cursor
            for li, (conv, ssm) in st["mamba"].items():
                c = self.cache["layers"][li]
                c.conv[slot].copy_(conv)
                c.ssm[slot].copy_(ssm)
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

    def on_release(self, req: Request) -> None:
        slot = self.slot_of.pop(req.rid, None)
        if slot is not None:
            self.free_slots.append(slot)
            self.slot_len[slot] = 0
        if self._pool_owned:
            # standalone (replica-less) use: the engine owns the pool
            self.pool.release(req.rid)

    def _lbucket(self, lmax: int) -> int:
        """Chunk-length bucket: the smallest quantum * 2^k >= lmax."""
        if lmax <= 0:
            return 1
        n = -(-lmax // self.quantum)
        p = 1
        while p < n:
            p *= 2
        return self.quantum * p

    def _block_row(self, out_row: np.ndarray, rid: int) -> None:
        ids = self.pool.block_table(rid)
        w = out_row.shape[0]
        out_row[:min(len(ids), w)] = ids[:w]

    def _maxb_ladder(self) -> list:
        """Page-window rungs: every width up to 4, then powers of two,
        then ``max_blocks``."""
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
        only positions past every row's query."""
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
        if self.pool.swapped_tokens(req.rid) > 0:
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
        decode batch does)."""
        slots = len(self.free_slots)
        blocks = self.pool.free
        for req in plan.decode:
            if req.rid not in self.slot_of:
                slots -= 1
            blocks -= self._blocks_needed(
                req.rid, self._tokens_cached(req.rid) + 1)
        if slots < 0 or blocks < 0:
            raise EngineBackpressure(
                f"engine cannot hold the decode batch: {len(plan.decode)} "
                f"decodes need more than the free {len(self.free_slots)} "
                f"slots / {self.pool.free} blocks — decode growth is never "
                f"deferrable; size the pool for the worst-case decode "
                f"footprint",
                kind="slots" if slots < 0 else "kv", n_prefill_fit=None,
                n_slots=self.n_slots, num_blocks=self.pool.num_blocks,
                block_size=self.block_size)
        fit = 0
        for req, chunk in plan.prefill:
            take = min(chunk, req.prompt_len - req.prefilled)
            need_slot = 1 if req.rid not in self.slot_of else 0
            need_blocks = self._blocks_needed(req.rid, req.prefilled + take)
            if slots - need_slot < 0 or blocks - need_blocks < 0:
                raise EngineBackpressure(
                    f"engine backpressure: prefill item {fit} (rid "
                    f"{req.rid}) does not fit — {slots} slots / {blocks} "
                    f"blocks left of n_slots={self.n_slots}, num_blocks="
                    f"{self.pool.num_blocks}; defer the prefill tail and "
                    f"retry",
                    kind="slots" if slots - need_slot < 0 else "kv",
                    n_prefill_fit=fit, n_slots=self.n_slots,
                    num_blocks=self.pool.num_blocks,
                    block_size=self.block_size, rid=req.rid)
            slots -= need_slot
            blocks -= need_blocks
            fit += 1

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    def _step(self, pre_tokens, pre_slots, pre_start, pre_len, pre_reset,
              pre_sample, dec_tokens, dec_start, dec_active, pre_bt,
              dec_bt) -> torch.Tensor:
        d = self._dev
        return fused_serve_forward(
            self.params, self.cfg, self.cache, d(pre_tokens), d(pre_slots),
            d(pre_start), d(pre_len), d(pre_reset), d(pre_sample),
            d(dec_tokens), d(dec_start), d(dec_active), pre_bt, dec_bt,
            self.moe_impl)

    def warm(self) -> None:
        """Build and load the kernels (on the card), and launch each once
        with a state-safe iteration: one pad prefill row on the sink row
        of the Mamba state and an inactive decode batch, with empty block
        tables, so every page write goes to the sink page and no live
        slot's state moves. Both sub-batches run every layer's FFN, the
        MoE ones through ``moe_impl``."""
        if self.device.type == "cuda":
            build.build()
        n = self.n_slots
        q = self.quantum
        z1 = np.zeros((1,), np.int32)
        self._step(np.zeros((1, q), np.int32), np.full((1,), n, np.int32),
                   z1, z1, np.zeros((1,), bool), z1,
                   self.last_token.copy(), self.slot_len.copy(),
                   np.zeros((n,), bool),
                   self._dev(np.full((1, 1), -1, np.int32)),
                   self._dev(np.full((n, 1), -1, np.int32)))

    def execute(self, plan: BatchPlan, now: float) -> float:
        t0 = time.perf_counter()
        self.preflight(plan)
        n = self.n_slots
        # ---- pack the plan (host-side numpy; no device ops)
        pre: List[tuple] = []       # (slot, req, toks)
        for req, chunk in plan.prefill:
            self._ensure_resident(req)
            slot = self.slot_of[req.rid]
            toks = self.tokens[req.rid][req.prefilled:req.prefilled + chunk]
            if req.prefilled != self.slot_len[slot]:
                raise RuntimeError(
                    f"rid {req.rid} resumes prefill at {req.prefilled} but "
                    f"slot {slot} holds {self.slot_len[slot]} tokens — a "
                    f"state-preserving resume needs the KV hierarchy")
            if req.prefilled + len(toks) > self.max_len:
                raise RuntimeError(
                    f"rid {req.rid} prefill would exceed max_len "
                    f"{self.max_len}; size prompts+decodes to the cache")
            if not self.pool.grow(req.rid, req.prefilled + len(toks)):
                raise EngineBackpressure(
                    f"KV pool exhausted growing rid {req.rid} to "
                    f"{req.prefilled + len(toks)} tokens — the scheduler "
                    "admitted beyond pool capacity",
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
            self._ensure_resident(req)   # mid-decode swap-resume
            slot = self.slot_of[req.rid]
            if self.slot_len[slot] + 1 > self.max_len:
                raise RuntimeError(
                    f"rid {req.rid} decode would exceed max_len "
                    f"{self.max_len}; size prompts+decodes to the cache")
            if not self.pool.grow(req.rid, int(self.slot_len[slot]) + 1):
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

        # ---- block tables, sliced to the page-window bucket covering the
        # longest live row; rebuilt only when a row's grant changed
        need = 1
        for _, req, toks in pre:
            need = max(need, blocks_for(req.prefilled + len(toks),
                                        self.block_size))
        for slot, rid in enumerate(emit_dec):
            if rid is not None:
                need = max(need, blocks_for(int(self.slot_len[slot]) + 1,
                                            self.block_size))
        maxb = self._maxb_bucket(need)
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
            self._pre_bt_key = pre_key
        dec_key = (nd, maxb, tuple((rid, ver(rid)) if rid is not None
                                   else None for rid in emit_dec))
        if dec_key != self._dec_bt_key:
            dec_bt = np.full((nd, maxb), -1, np.int32)
            for slot, rid in enumerate(emit_dec):
                if rid is not None:
                    self._block_row(dec_bt[slot], rid)
            self._dec_bt_dev = self._dev(dec_bt)
            self._dec_bt_key = dec_key

        # ---- ONE forward; the cache's pages and state written in place
        sampled = self._step(pre_tokens, pre_slots, pre_start, pre_len,
                             pre_reset, pre_sample,
                             self.last_token[:nd].copy(),
                             self.slot_len[:nd].copy(), dec_active,
                             self._pre_bt_dev, self._dec_bt_dev)
        out = sampled.cpu().numpy()   # the ONE device->host transfer
        self._buckets.add((P, L, nd, maxb))
        self.prefill_rows += len(pre)
        self.prefill_tokens += sum(len(t) for _, _, t in pre)

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
        # ---- SWA page reclamation: the fully dead leading blocks of every
        # live row (positions r <= len - W) go back to the pool
        if self._swa_reclaim_window is not None:
            W = self._swa_reclaim_window
            live = [(req.rid, slot) for slot, req, _ in pre]
            live += [(rid, slot) for slot, rid in enumerate(emit_dec)
                     if rid is not None]
            for rid, slot in live:
                dead = (int(self.slot_len[slot]) - W + 1) // self.block_size
                if dead > 0:
                    self.kv_blocks_reclaimed += \
                        self.pool.reclaim_prefix(rid, dead)
        elapsed = time.perf_counter() - t0
        self.iteration_log.append((plan.cost(), elapsed))
        return elapsed
