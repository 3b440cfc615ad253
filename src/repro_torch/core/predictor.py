"""Batch-latency predictor + decode-length estimator.

The paper trains a random-forest on Vidur simulator profiles (§3.6). Our TPU
adaptation (DESIGN.md §4.3) replaces it with an **analytical roofline model**
— T_iter = max(quadratic-in-chunk compute, affine-in-chunk memory) + overhead
— which is deterministic, O(1) to evaluate, family-aware (attention vs SSD
decode costs differ), and *invertible in closed form*: the dynamic-chunking
solver solves each roofline branch for the largest chunk analytically
(quadratic formula / piecewise-affine), snaps to the 128-quantized chunk
grid, and verifies the snap with at most a couple of exact probes — so the
result is guaranteed identical to the old monotone bisection, which is kept
as ``solve_max_chunk_bisect`` for the property-test oracle (docs/perf.md).

Hot-path discipline (this module is the innermost loop of every simulation):
numpy is imported once at module scope, per-candidate estimates are memoized
behind bounded LRU caches, and the batched helpers mirror the scalar
arithmetic operation-for-operation so vectorized and scalar paths are
bit-identical.

A least-squares calibration hook fits (mfu, overhead) residuals against
measured iterations when a real backend is used.

The same model doubles as the simulator's execution oracle (with optional
noise and separately perturbed constants, so the scheduler's predictions are
not trivially perfect — see sim/backend.py).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.models.config import ATTN, MAMBA, MOE, NONE, SWA, ModelConfig


@dataclass(frozen=True)
class HardwareSpec:
    name: str
    flops_peak: float          # bf16 FLOP/s per chip
    hbm_bw: float              # bytes/s per chip
    hbm_size: float            # bytes per chip
    link_bw: float             # bytes/s per ICI/NVLink link
    pcie_bw: float = 25e9      # bytes/s host link (KV swap tier transfers)
    mfu: float = 0.55          # achievable matmul fraction for mixed batches
    overhead_s: float = 2.5e-3 # per-iteration scheduling/launch overhead
    # intra-replica interconnect for tensor-parallel collectives (the
    # all-reduce-equivalent traffic fused TP serving pays per layer).
    # 0.0 falls back to link_bw — a separate field because the inter-
    # replica link (live migration) and the intra-replica ICI are
    # different fabrics on real pods (e.g. NVLink vs IB).
    ici_bw: float = 0.0


A100 = HardwareSpec("a100", 312e12, 2.039e12, 80e9, 300e9, mfu=0.55)
TPU_V5E = HardwareSpec("tpu_v5e", 197e12, 819e9, 16e9, 50e9, mfu=0.55)
# NVIDIA H100 SXM data sheet: 989 TFLOP/s dense bf16, 3.35 TB/s HBM3,
# 80 GB, NVLink 900 GB/s total (450 GB/s each way).
H100 = HardwareSpec("h100", 989e12, 3.35e12, 80e9, 450e9)


class LRUCache:
    """Small bounded LRU memo for hot-path estimates. Python dicts are
    insertion-ordered, so recency is maintained by delete+reinsert on hit
    and eviction pops the front. Recency tracking is *lazy*: below half
    capacity nothing can be evicted for a long while, so hits skip the
    reorder entirely (the hot path pays one plain dict get); once the
    cache passes half full, hits refresh recency so eviction approximates
    true LRU. Unlike the old clear-everything-at-100k policy, a long
    fleet sweep never drops the whole memo and re-pays cold-start cost
    mid-benchmark."""

    __slots__ = ("cap", "data", "_track")

    def __init__(self, cap: int):
        self.cap = cap
        self.data: dict = {}
        self._track = False

    def get(self, key):
        d = self.data
        v = d.get(key)
        if v is not None and self._track:
            del d[key]
            d[key] = v
        return v

    def put(self, key, value) -> None:
        d = self.data
        if key in d:
            del d[key]
        elif len(d) >= self.cap:
            del d[next(iter(d))]
        d[key] = value
        if not self._track and len(d) * 2 >= self.cap:
            self._track = True

    def __len__(self) -> int:
        return len(self.data)

    def clear(self) -> None:
        self.data.clear()
        self._track = False


@dataclass
class BatchPlanCost:
    """Composition of one serving iteration, as the predictor sees it."""
    prefill_items: Sequence[Tuple[int, int]]  # (chunk_tokens, prefix_len)
    decode_ctxs: Sequence[int]                # context length per decode req
    swap_bytes: float = 0.0                   # host->HBM KV swap-in this iter
    # optional precomputed (flops, bytes) aggregate for decode_ctxs — the
    # value attn_decode_cost_batch(decode_ctxs) would return. It depends
    # only on the model config (not hardware), so one computation serves
    # the scheduler's model, the solver's probes, and the sim oracle.
    decode_agg: Optional[Tuple[float, float]] = None


class ModelCostModel:
    """Analytical per-iteration cost for a model on a hardware target.

    All quantities are *per replica* (tensor-parallel degree ``tp`` divides
    flops/bytes across chips; the paper's Qwen-7B TP2 uses tp=2).
    """

    BYTES_W = 2   # bf16 weights
    BYTES_KV = 2  # bf16 kv cache
    PREFILL_CACHE_CAP = 131_072   # LRU entries (coarse-grid memo)
    DECODE_T1_CACHE_CAP = 65_536

    def __init__(self, cfg: ModelConfig, hw: HardwareSpec, tp: int = 1,
                 moe_dropless_sweep: bool = False):
        self.cfg = cfg
        self.hw = hw
        self.tp = tp
        c = cfg
        # ``moe_dropless_sweep``: price the dense every-expert dropless
        # sweep (the pre-grouped-GEMM serving path, kept in
        # ReferenceJaxEngine): (E - top_k)/top_k extra FFN flops per token
        # and a full expert-weight read per iteration. Default False —
        # the fused engine serves through the gather-based grouped GEMM
        # whose cost ~matches the capacity path the model already prices,
        # and the default arithmetic stays byte-identical to before.
        self.moe_dropless_sweep = moe_dropless_sweep
        if moe_dropless_sweep and c.moe is not None \
                and any(l.ffn == MOE for l in c.layers):
            self._moe_sweep_flops_per_tok = (
                2.0 * (c.moe.num_experts - c.moe.top_k) * 3
                * c.d_model * c.moe.d_ff_expert
                * sum(1 for l in c.layers if l.ffn == MOE))
        else:
            self._moe_sweep_flops_per_tok = 0.0
        self._n_active = c.param_count(active_only=True)
        self._n_total = c.param_count(active_only=False)
        # split attention-bearing vs mamba layers for per-family costs
        self._attn_layers = [l for l in c.layers if l.mixer in (ATTN, SWA)]
        self._mamba_layers = [l for l in c.layers if l.mixer == MAMBA]
        self._moe_layers = [l for l in c.layers if l.ffn == MOE]
        # hot-path aggregates (the chunk solver inverts these analytically)
        self._n_full = sum(1 for l in self._attn_layers
                           if not (l.mixer == SWA and l.window))
        self._swa_windows = [l.window for l in self._attn_layers
                             if l.mixer == SWA and l.window]
        self._swa_windows_arr = np.asarray(self._swa_windows,
                                           dtype=np.float64)
        self._hhd = 1.0 * c.num_heads * c.head_dim
        self._kv2 = 2.0 * c.num_kv_heads * c.head_dim * self.BYTES_KV
        if self._mamba_layers:
            s = c.ssm
            self._mamba_dec_f = len(self._mamba_layers) * 6.0 \
                * s.d_inner(c.d_model) * s.d_state
            self._mamba_dec_b = len(self._mamba_layers) * 4.0 \
                * s.d_inner(c.d_model) * s.d_state
            per_tok = 2.0 * s.chunk * s.d_inner(c.d_model) \
                + 6.0 * s.d_inner(c.d_model) * s.d_state
            self._ssd_per_chunk_tok = len(self._mamba_layers) * per_tok
        else:
            self._mamba_dec_f = self._mamba_dec_b = 0.0
            self._ssd_per_chunk_tok = 0.0
        # --- tensor-parallel collective term (docs/engine.md §Sharded
        # serve): at tp>1 every layer pays two all-reduce-equivalent
        # exchanges of the [tokens, d_model] residual (attention combine
        # and FFN combine), each moving 2*(tp-1)/tp of the tensor per
        # chip under a ring schedule. Priced per token so the chunk
        # solver inverts it as a linear term; exactly 0.0 at tp=1, which
        # keeps every tp=1 float bit-identical to the pre-TP model.
        if tp > 1:
            ici = hw.ici_bw if hw.ici_bw > 0.0 else hw.link_bw
            self._comm_bytes_per_tok = (
                2.0 * len(c.layers) * c.d_model * self.BYTES_W
                * 2.0 * (tp - 1) / tp)
            self._comm_s_per_tok = self._comm_bytes_per_tok / ici
        else:
            self._comm_bytes_per_tok = 0.0
            self._comm_s_per_tok = 0.0
        self._prefill_est_cache = LRUCache(self.PREFILL_CACHE_CAP)
        self._decode_t1_cache = LRUCache(self.DECODE_T1_CACHE_CAP)
        # identity token for externally-held estimate caches (per-Request
        # slots, prefill-table views): calibrate() mints a new one, so
        # every cache keyed on it self-invalidates when the hardware
        # constants change
        self.cache_token = object()
        # hot-loop constants (same products the methods would compute)
        self._n_attn = len(self._attn_layers)
        self._kv_tok = 2 * c.num_kv_heads * c.head_dim * self.BYTES_KV
        dense_params = c.param_count(active_only=True)
        if c.moe is not None and self._moe_layers:
            act = c.moe.top_k * 3 * c.d_model * c.moe.d_ff_expert
            dense_params -= len(self._moe_layers) * act
            self._w_expert_bytes = (
                len(self._moe_layers) * c.moe.num_experts * 3
                * c.d_model * c.moe.d_ff_expert * self.BYTES_W)
        else:
            self._w_expert_bytes = 0.0
        self._w_dense_bytes = dense_params * self.BYTES_W
        if c.encoder is not None:
            # encoder runs once per request at first prefill; folded into
            # the first chunk's cost via _encoder_flops
            self._enc_flops = (6 * c.encoder.num_layers *
                               (c.d_model ** 2) * 4 +  # qkvo+ffn rough
                               2 * c.encoder.num_layers * 2 *
                               c.num_heads * c.head_dim *
                               c.encoder.num_positions) * c.encoder.num_positions
        else:
            self._enc_flops = 0.0

    # ------------------------------------------------ component costs
    def kv_bytes_per_token_layer(self) -> float:
        c = self.cfg
        return 2 * c.num_kv_heads * c.head_dim * self.BYTES_KV

    def _attn_ctx(self, l, ctx: int) -> int:
        if l.mixer == SWA and l.window is not None:
            return min(ctx, l.window)
        return ctx

    def _eff_ctx_sum(self, ctx: float) -> float:
        """Sum over attention layers of the visible context (SWA clamps).
        All terms are integer-valued, so the vectorized min/sum is exact
        (bit-identical to the old per-window Python loop)."""
        e = self._n_full * ctx
        if self._swa_windows:
            e += float(np.minimum(self._swa_windows_arr, ctx).sum())
        return e

    def attn_flops_prefill(self, chunk: int, prefix: int) -> float:
        """QK^T + PV flops for a chunk attending to prefix + itself."""
        return 4.0 * self._hhd * chunk * (self._eff_ctx_sum(prefix)
                                          + len(self._attn_layers) * chunk / 2)

    def attn_decode_cost(self, ctx: int) -> Tuple[float, float]:
        """(flops, kv_read_bytes) for one decode token at context ctx."""
        e = self._eff_ctx_sum(ctx)
        f = 4.0 * self._hhd * e + self._mamba_dec_f
        b = self._kv2 * e + self._mamba_dec_b
        return f, b

    def attn_decode_cost_batch(self, ctxs) -> Tuple[float, float]:
        """Vectorized (flops, bytes) totals for a decode batch. Small
        Python lists take a scalar path (numpy dispatch overhead dominates
        tiny batches); context sums are integer-valued either way, so both
        paths produce the same float."""
        n = len(ctxs)
        if n == 0:
            return 0.0, 0.0
        if n <= 16 and not isinstance(ctxs, np.ndarray):
            nf, es = self._n_full, 0.0
            if self._swa_windows:
                ws = self._swa_windows
                for ctx in ctxs:
                    e = nf * ctx
                    for w in ws:
                        e += min(ctx, w)
                    es += e
            else:
                for ctx in ctxs:
                    es += nf * ctx
        else:
            a = np.asarray(ctxs, dtype=np.float64)
            e = self._n_full * a
            for w in self._swa_windows:
                e = e + np.minimum(a, w)
            es = float(e.sum())
        return (4.0 * self._hhd * es + n * self._mamba_dec_f,
                self._kv2 * es + n * self._mamba_dec_b)

    def ssd_flops_prefill(self, chunk_tokens: int) -> float:
        """SSD chunked-scan extra flops (beyond projections) per chunk."""
        return self._ssd_per_chunk_tok * chunk_tokens

    def weight_read_bytes(self, tokens: int) -> float:
        """Weights streamed from HBM for one iteration. MoE experts are
        only read in proportion to how many are activated by the batch."""
        c = self.cfg
        if self._w_expert_bytes and c.moe is not None:
            if self._moe_sweep_flops_per_tok:
                frac = 1.0      # dense sweep touches every expert
            else:
                frac = min(1.0, tokens * c.moe.top_k / c.moe.num_experts)
        else:
            frac = 0.0
        return self._w_dense_bytes + self._w_expert_bytes * frac

    # ------------------------------------------------ iteration time
    def iteration_time(self, plan: BatchPlanCost) -> float:
        items = plan.prefill_items
        chunk_total = 0
        for ch, _ in items:
            chunk_total += ch
        tokens = chunk_total + len(plan.decode_ctxs)
        if tokens == 0:
            return 0.0
        flops = 2.0 * self._n_active * tokens
        if self._moe_sweep_flops_per_tok:
            flops += self._moe_sweep_flops_per_tok * tokens
        flops += self._ssd_per_chunk_tok * chunk_total
        byts = self.weight_read_bytes(tokens)
        for ch, pre in items:
            flops += self.attn_flops_prefill(ch, pre)
            if pre == 0 and self._enc_flops:
                flops += self._enc_flops
            # kv write for the chunk + RE-READ of the whole cached prefix
            # (flash attention streams prefix KV once per chunk — the real
            # cost behind the paper's small-chunk throughput loss, Fig 4)
            byts += ch * self._n_attn * self._kv_tok
            byts += self._kv2 * self._eff_ctx_sum(pre)
        f, b = plan.decode_agg if plan.decode_agg is not None \
            else self.attn_decode_cost_batch(plan.decode_ctxs)
        flops += f
        byts += b
        # activations traffic ~ 12 * d_model * tokens (residual streams)
        byts += 12.0 * self.cfg.d_model * tokens * self.BYTES_W
        t_compute = flops / (self.hw.flops_peak * self.hw.mfu * self.tp)
        t_memory = byts / (self.hw.hbm_bw * self.tp)
        t = max(t_compute, t_memory) + self.hw.overhead_s
        if self._comm_s_per_tok:
            t += tokens * self._comm_s_per_tok
        if plan.swap_bytes:
            # KV swap-in crosses the host link before the batch can attend
            # to it — serial with the iteration, not overlapped
            t += plan.swap_bytes / (self.hw.pcie_bw * self.tp)
        return t

    def decode_iteration_time(self, decode_ctxs: Sequence[int]) -> float:
        return self.iteration_time(BatchPlanCost((), decode_ctxs))

    def prefill_time_estimate(self, remaining: int, prefix: int,
                              chunk: int = 2048) -> float:
        """Estimated time to prefill ``remaining`` tokens (priority eq 4/5
        work term) assuming throughput-optimal chunks. Memoized on a
        coarse grid behind a bounded LRU — it is called per candidate per
        iteration. The per-chunk roofline sum is evaluated in one
        vectorized pass (`_prefill_time_chunks`) whose arithmetic mirrors
        ``iteration_time`` bit-for-bit."""
        if remaining <= 0:
            return 0.0
        key = (-(-remaining // 64)) * 1_048_576 + (prefix // 256) \
            if chunk == 2048 else (remaining, prefix, chunk)
        cache = self._prefill_est_cache
        hit = cache.get(key)
        if hit is not None:
            return hit
        t = self._prefill_time_chunks(remaining, prefix, chunk)
        cache.put(key, t)
        return t

    def _prefill_time_chunks(self, remaining: int, prefix: int,
                             chunk: int) -> float:
        """Sum of the per-chunk roofline over the whole prefill, evaluated
        closed-form per chunk in one vectorized expression (no
        ``iteration_time`` calls). Every elementwise op replicates the
        scalar op order and the final reduction is sequential, so the
        result is bit-identical to looping ``iteration_time`` chunk by
        chunk (the equivalence contract of docs/perf.md)."""
        n = -(-remaining // chunk)
        if n == 1:
            return self.iteration_time(
                BatchPlanCost(((remaining, prefix),), ()))
        c = np.full(n, float(chunk))
        c[-1] = remaining - (n - 1) * chunk
        p = prefix + chunk * np.arange(n, dtype=np.float64)
        la = len(self._attn_layers)
        flops = 2.0 * self._n_active * c
        if self._moe_sweep_flops_per_tok:
            flops = flops + self._moe_sweep_flops_per_tok * c
        if self._ssd_per_chunk_tok:
            flops = flops + self._ssd_per_chunk_tok * c
        e = self._n_full * p
        for w in self._swa_windows:
            e = e + np.minimum(p, w)
        flops = flops + (4.0 * self._hhd) * c * (e + (la * c) / 2)
        if prefix == 0 and self._enc_flops:
            flops[0] += self._enc_flops
        cfg = self.cfg
        if self._w_expert_bytes and cfg.moe is not None:
            if self._moe_sweep_flops_per_tok:
                frac = 1.0
            else:
                frac = np.minimum(
                    1.0, (c * cfg.moe.top_k) / cfg.moe.num_experts)
        else:
            frac = 0.0
        byts = self._w_dense_bytes + self._w_expert_bytes * frac
        byts = byts + (c * la) * self._kv_tok
        byts = byts + self._kv2 * e
        byts = byts + ((12.0 * cfg.d_model) * c) * self.BYTES_W
        t_compute = flops / (self.hw.flops_peak * self.hw.mfu * self.tp)
        t_memory = byts / (self.hw.hbm_bw * self.tp)
        t = np.maximum(t_compute, t_memory) + self.hw.overhead_s
        if self._comm_s_per_tok:
            # same op order as the scalar path: tokens == c per chunk here
            t = t + c * self._comm_s_per_tok
        return sum(t.tolist())

    def decode_time_estimate(self, n_tokens: int, ctx: int,
                             batch_hint: int = 32) -> float:
        """Estimated time to emit n_tokens at context ctx, amortized over a
        typical co-running decode batch. The per-token time ``t1`` depends
        only on (ctx, batch_hint) and is memoized — this is the hottest
        estimate in the scheduler (priority keys + violation verdicts)."""
        if n_tokens <= 0:
            return 0.0
        key = (ctx, batch_hint)
        t1 = self._decode_t1_cache.get(key)
        if t1 is None:
            t1 = self.iteration_time(
                BatchPlanCost((), [ctx] * max(1, batch_hint))) \
                / max(1, batch_hint)
            self._decode_t1_cache.put(key, t1)
        return n_tokens * t1

    # ------------------------------------------------ TP collective costs
    def comm_seconds(self, plan: BatchPlanCost) -> float:
        """TP collective time this plan pays (the comm share of
        ``iteration_time``) — 0.0 at tp=1. Recorded in BatchPlan.trace so
        SLO attribution can name collective overhead as a cause bin."""
        if not self._comm_s_per_tok:
            return 0.0
        tokens = len(plan.decode_ctxs)
        for ch, _ in plan.prefill_items:
            tokens += ch
        return tokens * self._comm_s_per_tok

    def comm_bytes(self, tokens: int) -> float:
        """All-reduce-equivalent bytes ``tokens`` move across the TP
        interconnect per iteration (0.0 at tp=1)."""
        return tokens * self._comm_bytes_per_tok

    # ------------------------------------------------ KV transfer costs
    def kv_transfer_bytes(self, tokens: int) -> float:
        """Bytes of attention KV state for ``tokens`` of context (Mamba/SSD
        recurrent state is O(1) per layer and negligible beside it)."""
        return (tokens * len(self._attn_layers)
                * self.kv_bytes_per_token_layer())

    def host_transfer_time(self, nbytes: float) -> float:
        """Seconds to move ``nbytes`` across the PCIe/host link (KV swap)."""
        return nbytes / (self.hw.pcie_bw * self.tp)

    def link_transfer_time(self, nbytes: float) -> float:
        """Seconds to move ``nbytes`` replica-to-replica (live migration).
        KV is sharded over ``tp`` chips, each with its own link, so the
        transfer parallelizes — same scaling as the other bandwidths."""
        return nbytes / (self.hw.link_bw * self.tp)

    # ------------------------------------------------ chunk solver
    def solve_max_chunk(self, slack: float, prefix: int,
                        decode_ctxs: Sequence[int],
                        max_chunk: int = 8192, quantum: int = 128,
                        swap_bytes: float = 0.0,
                        decode_agg: Optional[Tuple[float, float]] = None
                        ) -> int:
        """Largest chunk (multiple of ``quantum``, TPU lane alignment —
        DESIGN.md §4.2) whose mixed-batch iteration fits in ``slack``.
        ``swap_bytes`` charges a pending host->HBM KV swap-in against the
        same slack.

        Closed-form: both roofline branches invert analytically
        (`_chunk_upper_bound`), the real-valued bound is floored to the
        quantum grid, and one or two exact probes against the same
        arithmetic as ``iteration_time`` correct any floating-point snap —
        so the result is guaranteed equal to ``solve_max_chunk_bisect``
        (the retained test oracle) at O(1) cost. Returns 0 if even one
        quantum does not fit."""
        if slack <= 0:
            return 0
        hi = max_chunk // quantum
        if slack == float("inf"):
            return hi * quantum
        ctx = self._chunk_probe_ctx(decode_ctxs, prefix, decode_agg)
        c_star = self._chunk_upper_bound(slack, prefix, swap_bytes, ctx)
        k = int(c_star // quantum) if c_star > 0 else 0
        k = min(max(k, 0), hi)
        # snap verification: probe arithmetic == iteration_time bit-for-bit
        while k > 0 and self._chunk_probe_time(
                k * quantum, prefix, swap_bytes, ctx) > slack:
            k -= 1
        while k < hi and self._chunk_probe_time(
                (k + 1) * quantum, prefix, swap_bytes, ctx) <= slack:
            k += 1
        return k * quantum

    def solve_max_chunk_bisect(self, slack: float, prefix: int,
                               decode_ctxs: Sequence[int],
                               max_chunk: int = 8192, quantum: int = 128,
                               swap_bytes: float = 0.0) -> int:
        """Monotone-bisection reference solver (the pre-optimization
        implementation, kept as the property-test oracle)."""
        if slack <= 0:
            return 0
        lo, hi = 0, max_chunk // quantum
        while lo < hi:
            mid = (lo + hi + 1) // 2
            t = self.iteration_time(
                BatchPlanCost(((mid * quantum, prefix),), decode_ctxs,
                              swap_bytes))
            if t <= slack:
                lo = mid
            else:
                hi = mid - 1
        return lo * quantum

    def _chunk_probe_ctx(self, decode_ctxs, prefix: int,
                         decode_agg: Optional[Tuple[float, float]] = None
                         ) -> tuple:
        """Per-solve constants: decode-batch aggregates and the prefix's
        effective-context terms, computed once and reused by every probe."""
        dec_f, dec_b = decode_agg if decode_agg is not None \
            else self.attn_decode_cost_batch(decode_ctxs)
        e_p = self._eff_ctx_sum(prefix)
        return (len(decode_ctxs), dec_f, dec_b, e_p, self._kv2 * e_p)

    def _chunk_probe_time(self, chunk: int, prefix: int, swap_bytes: float,
                          ctx: tuple) -> float:
        """Iteration time for one (chunk, prefix) prefill item plus the
        solve's decode batch. Replicates ``iteration_time``'s accumulation
        order exactly (same floats in, same partial sums), with the
        decode aggregates precomputed — bit-identical results at a
        fraction of the cost (tested in test_hotpath.py)."""
        n_dec, dec_f, dec_b, _e_p, kv_e_p = ctx
        tokens = chunk + n_dec
        flops = 2.0 * self._n_active * tokens
        if self._moe_sweep_flops_per_tok:
            flops += self._moe_sweep_flops_per_tok * tokens
        flops += self._ssd_per_chunk_tok * chunk
        byts = self.weight_read_bytes(tokens)
        flops += self.attn_flops_prefill(chunk, prefix)
        if prefix == 0 and self._enc_flops:
            flops += self._enc_flops
        byts += chunk * self._n_attn * self._kv_tok
        byts += kv_e_p
        flops += dec_f
        byts += dec_b
        byts += 12.0 * self.cfg.d_model * tokens * self.BYTES_W
        t_compute = flops / (self.hw.flops_peak * self.hw.mfu * self.tp)
        t_memory = byts / (self.hw.hbm_bw * self.tp)
        t = max(t_compute, t_memory) + self.hw.overhead_s
        if self._comm_s_per_tok:
            t += tokens * self._comm_s_per_tok
        if swap_bytes:
            t += swap_bytes / (self.hw.pcie_bw * self.tp)
        return t

    def _chunk_upper_bound(self, slack: float, prefix: int,
                           swap_bytes: float, ctx: tuple) -> float:
        """Real-valued chunk size where the roofline meets ``slack``:
        invert T(c) = max(F(c)/K_f, B(c)/K_b) + overhead + swap.

        F(c) = a2*c^2 + a1*c + a0 (attention makes it quadratic) inverts
        via the quadratic formula; B(c) is affine in c except for the MoE
        expert-activation fraction, which caps at 1 — two affine pieces,
        each inverted directly. The bound is then min over branches.

        The TP collective term gamma*(c + n_dec) is linear and OUTSIDE the
        roofline max, so it folds exactly: the decode share comes off the
        budget and the per-chunk share augments each branch's linear
        coefficient by gamma*K (max(A,B) + gamma*c == max(A+gamma*c,
        B+gamma*c))."""
        n_dec, dec_f, dec_b, e_p, _kv_e_p = ctx
        cfg = self.cfg
        la = len(self._attn_layers)
        gamma = self._comm_s_per_tok
        budget = slack - self.hw.overhead_s
        if swap_bytes:
            budget -= swap_bytes / (self.hw.pcie_bw * self.tp)
        if gamma:
            budget -= n_dec * gamma
        if budget <= 0:
            return 0.0
        # --- compute branch: a2*c^2 + a1*c + a0 <= budget * K_f
        k_f = self.hw.flops_peak * self.hw.mfu * self.tp
        a2 = 2.0 * self._hhd * la
        a1 = 2.0 * self._n_active + self._ssd_per_chunk_tok \
            + self._moe_sweep_flops_per_tok + 4.0 * self._hhd * e_p \
            + gamma * k_f
        a0 = (2.0 * self._n_active
              + self._moe_sweep_flops_per_tok) * n_dec + dec_f
        if prefix == 0 and self._enc_flops:
            a0 += self._enc_flops
        rhs_f = budget * k_f - a0
        if rhs_f <= 0:
            return 0.0
        if a2 > 0:
            c_f = (-a1 + math.sqrt(a1 * a1 + 4.0 * a2 * rhs_f)) / (2.0 * a2)
        else:
            c_f = rhs_f / a1
        # --- memory branch: W(c + n_dec) + b1*c + b0 <= budget * K_b
        k_b = self.hw.hbm_bw * self.tp
        b1 = la * self._kv_tok \
            + 12.0 * self.cfg.d_model * self.BYTES_W \
            + gamma * k_b
        b0 = self._w_dense_bytes + self._kv2 * e_p + dec_b \
            + 12.0 * cfg.d_model * n_dec * self.BYTES_W
        w_exp = self._w_expert_bytes if cfg.moe is not None else 0.0
        if w_exp and self._moe_sweep_flops_per_tok:
            # dense sweep: full expert read is a constant, not activation-
            # fraction dependent
            b0 += w_exp
            w_exp = 0.0
        rhs_b = budget * k_b - b0
        if not w_exp:
            c_m = rhs_b / b1
        else:
            per_tok = w_exp * cfg.moe.top_k / cfg.moe.num_experts
            kink_tokens = cfg.moe.num_experts / cfg.moe.top_k
            c_a = (rhs_b - per_tok * n_dec) / (b1 + per_tok)
            if c_a + n_dec <= kink_tokens:
                c_m = c_a
            else:
                c_m = (rhs_b - w_exp) / b1
        return min(c_f, c_m)

    # ------------------------------------------------ calibration
    def calibrate(self, samples: List[Tuple[BatchPlanCost, float]]) -> None:
        """Least-squares fit of (1/mfu_eff, overhead) so that predicted
        iteration times match measured ones (used with the real JAX
        backend, whose CPU timings bear no relation to TPU constants)."""
        if len(samples) < 4:
            return
        rows, ys = [], []
        for plan, measured in samples:
            base = self.iteration_time(plan) - self.hw.overhead_s
            rows.append([base, 1.0])
            ys.append(measured)
        a, res, *_ = np.linalg.lstsq(np.asarray(rows), np.asarray(ys),
                                     rcond=None)
        scale, overhead = float(a[0]), float(a[1])
        if scale > 0:
            self.hw = replace(self.hw,
                              mfu=self.hw.mfu / scale,
                              overhead_s=max(0.0, overhead))
            # memoized estimates embed the old constants — clear the
            # model-level memos and invalidate every external cache keyed
            # on the old token (per-Request slots, prefill-table views)
            self._prefill_est_cache.clear()
            self._decode_t1_cache.clear()
            self.cache_token = object()


class DecodeLengthEstimator:
    """Per-application running statistics of generated token counts; the
    scheduler over-approximates decode length as mean + 2*sigma (§3.4).
    ``estimate`` is called per candidate per scheduling iteration, so the
    derived value is cached per app and invalidated on ``observe``."""

    def __init__(self, prior_mean: float = 256.0, prior_std: float = 256.0):
        self.prior_mean = prior_mean
        self.prior_std = prior_std
        self._n: Dict[str, int] = {}
        self._mean: Dict[str, float] = {}
        self._m2: Dict[str, float] = {}
        self._est_cache: Dict[str, float] = {}
        self.version = 0   # bumped on observe; lets callers cache columns

    def observe(self, app_id: str, decode_len: int) -> None:
        n = self._n.get(app_id, 0) + 1
        mean = self._mean.get(app_id, 0.0)
        d = decode_len - mean
        mean += d / n
        self._m2[app_id] = self._m2.get(app_id, 0.0) + d * (decode_len - mean)
        self._n[app_id] = n
        self._mean[app_id] = mean
        self._est_cache.pop(app_id, None)
        self.version += 1

    def estimate(self, app_id: str) -> float:
        v = self._est_cache.get(app_id)
        if v is not None:
            return v
        n = self._n.get(app_id, 0)
        if n < 8:
            v = self.prior_mean + 2 * self.prior_std
        else:
            mean = self._mean[app_id]
            var = self._m2[app_id] / max(1, n - 1)
            v = mean + 2.0 * math.sqrt(max(0.0, var))
        self._est_cache[app_id] = v
        return v
