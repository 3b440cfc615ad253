"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

  python3 chip_smoke.py

Phases, each of which fails the run if it fails:

1. build: compile every CUDA kernel of ``src/repro_torch/csrc`` with
   nvcc, one process per source, all started at once;
2. kernels: each kernel against its plain PyTorch version on the card, at
   the main paths' shapes, in f32 (TF32 off in matmuls and cuDNN) and
   bf16 (the int8 decode kernel: int8 pages made by the port's
   ``_quantize``, with an f32 and a bf16 query), with its time, the plain
   version's, one library call's where one computes the same function
   (``F.scaled_dot_product_attention`` over the same data gathered to a
   dense view, for int8 pages a view dequantized beforehand;
   ``F.rms_norm`` with weight ``1 + w``; none for ``ssd_scan``), and the
   least time the card could take; decode also at one row of 1500 and
   one of 4096 tokens (64 pages, 32 splits) in bf16 and int8, the norm's
   backward at [1024, D] for the trained widths (3072, 768, 2048, 2560)
   in f32 and bf16 against ``rmsnorm_bwd_ref`` (yardstick: the backward
   of ``F.rms_norm`` through autograd, several calls), the dense
   layout's 256-token pages (8 slots of 2048 positions viewed as pages of
   a ``[9, 2048, KV, D]`` cache, an iota block table) at H24 KV8 D128
   and at H16 KV16 D64 in f32 and bf16, each row alone equal to its row
   of the batch bit for bit, prefill at
   the profile's shape (one row, C = S = 1024, bf16), decode and prefill
   in bf16 at the head layouts of qwen3-moe-30b-a3b (H32 KV4 D64, G 8),
   qwen-7b (H32 KV32 D128, G 1) and starcoder2-15b (H48 KV4 D128, G 12),
   gemma3-4b's head_dim 256 (H8 KV4) in f32 and bf16: decode (both page
   types, -1 holes), prefill with and without its 1024-token window over
   a 2048-token view, windowed decode rows (C = 1) over the view, and
   the same rows over a view whose dead blocks are -1 holes (equal, bit
   for bit, to the view without holes), the norm at d_model 2560 and
   8192 and over whisper-medium's [1500, 1024] f32 encoder rows; the
   scan at one
   chunk, at a ragged length read in place and at d_state 16 (nh 128);
   the scan's backward against ``ssd_scan_bwd_ref`` in f32 and bf16 at
   mamba2-370m's widths (1 and 2 x 1024), jamba-v0.1's (nh 128, d_state
   16), small_100m's (8 x 128, chunk 64) and 2 x 700 with a zero-dt tail
   (no library call computes it), beside the bound of its tensor-core
   products and the first version's fp32 bound; the static
   mode of the prefill kernel timed beside SDPA;
   and the kernels' invariance bit for bit on the card: each decode row
   served alone against the same row in the 8-row batch and the 32-page
   table against the same table widened to 64 columns of -1 (bf16 and
   int8 pages), each prefill row and each scan row alone against the same
   row in the 4-row batch, norm rows alone against the same rows of
   [8, D] and [1024, D], the scan's backward rows (dx, ddt, dB, dC, dh0)
   alone against the 2- and 8-row batches and its dA from run to run;
3. serve: full-width llama3.2-3b (paged, then ``--kv-layout dense``: the
   decode kernel over 256-token pages and the prefill kernel over the
   slots' rows) and full-width mamba2-370m through
   ``repro_torch.launch.serve.main``, then llama3.2-3b with int8 KV pages
   (``TorchEngine(kv_quant=True)`` in the same replica), full-width
   qwen3-moe-30b-a3b (48 layers, 128 experts, top-8, the grouped MoE),
   the paper's llama3-8b and gemma3-4b (34 layers, five of every six
   sliding with a 1024-token window, head_dim 256; prompts of 1100-1899
   tokens, longer than the window) through ``make_torch_replica``,
   random weights from a seed, bf16, the NiyamaScheduler priced on the
   H100 spec; every request must finish with all its tokens, every
   kernel of each path must have launched in that path's run (counts
   zeroed just before it; gemma3-4b: the prefill kernel with the window
   at D 256 and the decode kernel at D 256), no kernel of another path
   may have, and no plain version may have run;
   the MoE path's host reads of its largest expert segment are counted;
   each engine is freed before the next model is built;
4. profile: one decode and one prefill iteration of each served engine
   (the int8 one: decode; gemma3-4b's at positions past its window),
   timed on the host and traced with
   torch.profiler (device time by kernel, idle share; for the MoE engine
   also the expert products, the router and the combine);
5. parity: full-width 2-layer f32 copies of both families, of llama
   with int8 pages, of qwen3-moe-30b-a3b and of gemma3-4b (a
   sliding-window and a global layer), run one mixed iteration
   through the kernels and through the plain versions; the final hidden
   states and the written pages or state rows agree within the limits
   stated there and the sampled ids are equal (gemma3-4b: or a logged
   near-tie);
   and the grouped MoE
   against the dropless one on a 1024-token row;
6. hierarchy: full-width llama3.2-3b with bf16 and with int8 pages: four
   requests sharing a 1024-token prefix stream the same tokens with the
   KV hierarchy's prefix tier as without it and dispatch fewer prefill
   tokens; a mid-decode swap-out and swap-in round trip streams what an
   uninterrupted run streams;
7. reclaim: full-width llama3.2-3b in its ``long_500k`` variant (every
   layer sliding, window 8192) sheds the dead blocks of a 9000-token
   prompt and of its decode, hands a freed page to a request admitted
   after, and streams what the same engine streams with reclamation off;
8. fleet: two full-width llama3.2-3b engines (bf16) on worker threads
   in one ``make_async_torch_fleet``: under a virtual clock, one live
   move of a decoding request and one relegation-offload transfer
   mid-prefill, every stream against one ``make_torch_replica``'s (a
   logged near-tie passes); on the wall clock, 12 requests of the JAX
   fleet driver's mix streamed through ``AsyncServer`` (each once, with
   all its tokens), then the same mix through a fleet of one engine, the
   streams held to each other; both engines served prefill and decode
   rows, the decode, prefill and norm kernels launched, no plain version
   ran; wall tok/s, stream TTFT and TBT, migrations and bytes moved of
   both, and each engine's wall ms per iteration; the two-engine wall
   run serves ``GET /metrics`` (``AsyncServer(metrics_port=0)``), read
   from 127.0.0.1 while the streams run and after them, when
   ``repro_requests_finished_total`` must equal the requests streamed;
9. reference: full-width llama3.2-3b and mamba2-370m (bf16): the serve
   script's 12-request mix through the fused paged engine with a
   recording fixed-clock shim, then the same plans replayed into
   ``ReferenceTorchEngine`` and (llama) the dense ``TorchEngine``, same
   weights; streams equal to the paged engine's or diverging at a logged
   near-tie (counted); the reference run launches the norm kernel (and
   the scan for mamba2) and nothing else, the dense run the attention
   kernels and the norm, no plain version; then (llama) the same plans
   through 4 of its 28 layers at full width in f32 (TF32 off) by the
   fused paged, reference and dense engines, whose streams must be
   equal with no near-tie allowed;
10. whisper-medium at full width (24 + 24 layers, bf16) through the
   reference engine behind the NiyamaScheduler (max_len 512, 8 requests
   of 16-128 prompt and 8-32 output tokens): tok/s, iterations, the
   encoder's ms per prefill call, the norm kernel's launches; then 2 + 2
   full-width layers in f32 with random frames, kernels against plain;
11. internvl2-76b at full width cut to 4 of its 80 layers (bf16, the
   vision stub): 6 requests through the fused paged engine and the same
   plans through the reference engine, streams agreeing;
12. obs: the observability plane (``repro_torch.obs``) on full-width
   llama3.2-3b (bf16, the serve phase's replica and geometry): (a) 6 of
   the serve phase's requests behind the fixed-clock shim, untraced then
   traced (a lifecycle recorder installed): equal plan digests
   (``sim.trace.trace_digest``) and streams, and each run's host wall ms
   an iteration (the recorder's overhead); (b) the 12 requests through
   the serve script with ``--trace-out`` and ``--trace-chrome`` on the
   wall clock (files under ``chiprun_out/``): the events validate, each
   request's breakdown sums to its end-to-end latency within 1e-9 s, the
   attribution table and the seconds by cause (``predictor_error``
   among them) are printed, and the replica's scrape mirrors its
   iterations and the engine's prefill tokens; every run launches the
   attention kernels and the norm, no plain version;
13. train: the training path (``repro_torch.engine.steps``, the norm's
   and the scan's forward and backward kernels; the kernels phase holds
   the backwards against ``rmsnorm_bwd_ref`` and ``ssd_scan_bwd_ref``,
   rows alone and dw / dA from run to run bit for bit): (a) f32 gradient
   parity, TF32 off, of full-width llama3.2-3b at 4 of 28 layers, batch
   2 x 512, kernels against ``ops.plain_versions()``; (b) 3 AdamW steps
   of full-width, full-depth llama3.2-3b in f32 (3.61 B parameters),
   remat on, batch 2 x 512, through ``make_train_step``: finite losses,
   moving parameters, seconds a step, tokens/s, peak memory and the
   kernels' launches against the count predicted from the depth; (e1)
   the parity of (a) for full-width mamba2-370m at 4 of 48 layers, batch
   2 x 1024 (four chunks a row, so the state's gradient crosses chunks);
   (e2) 3 AdamW steps of full-width, full-depth mamba2-370m in f32 at
   2 x 1024, as (b), with the scan's launches against 2L forward and L
   backward calls a step, then one more step profiled: its wall ms, the
   device's busy ms and idle share, and device ms by kernel (the scan's
   forward and backward, the norm's two directions, GEMMs, the rest);
   (e3) the parity of (a) for full-width
   jamba-v0.1-52b cut to its first 2 of 32 layers (a Mamba layer with a
   dense FFN and one with the 16-expert MoE, nh 128, d_state 16); (c)
   ``repro_torch.launch.train`` for llama3.2-3b, qwen3-moe-30b-a3b,
   gemma3-4b, mamba2-370m and jamba-v0.1-52b at ``small_100m``, 200
   steps each (the Mamba families, whose loss falls from the start, 60),
   the last logged loss below the first; (d) the llama run's
   checkpoint restored equal to the state in memory, and one step from
   each equal bit for bit. The runs of (b), (e2) and (c) launch the
   norm's two kernels, and for the Mamba families the scan's two, and
   nothing else, and no plain version;
14. tp: tensor-parallel serve at TP = 2, both ranks (two processes, each
   holding its shard) on the one card, joined over gloo (NCCL refuses
   two ranks on one device; the phase asserts gloo): (a) full-width,
   full-depth qwen-7b (the paper's TP2 model, bf16): a tp = 1 wall run of
   6 requests of the serve mix under ``--max-len 512`` records its plans
   (``_Recorder(wall=True)``), and they replay into ``TorchEngine(tp=2)``
   in bf16 (streams equal, or parted at a logged near-tie), in f32 at 4
   of 32 layers with TF32 off (equal, no near-tie; sampled hidden states
   within ``TP_F32_HIDDEN_REL``; bit-equality printed) and with int8
   pages (against a tp = 1 int8 replay); each replay's counts zeroed on
   every rank just before it: every rank launched the decode and prefill
   kernels at its local head counts (H16 KV16) only, ran no plain
   version, and its gathers received, summed over the ranks, exactly
   ``TPServePlan.collective_bytes`` of the rows they moved; then
   ``make_torch_replica(tp=2)`` on the wall clock, its tok/s and TTFT /
   TBT p50 / p99 beside the tp = 1 run's; (b) ``python -m
   repro_torch.launch.serve --tp 2`` on full-width llama3.2-3b (H12 KV4 a
   rank), which must print ``tp=2``; (c) jamba-v0.1-52b at full widths,
   its first 8 of 32 layers: a tp = 1 run recorded, freed, replayed into
   TP = 2 (H16 KV4 and 8 of 16 experts a rank, the scan on both) in
   bf16, where a stream may also part after the first live token routed
   to other experts if that routing was a near-tie, and at 5 layers in
   f32 with no near-tie and no routing difference. Each engine and its
   ranks are stopped and freed before the next;
15. sharding: the sharding rules' steps on the 1x1 host mesh
   (``launch.mesh.make_host_mesh("cuda")``): (a) full-width llama3.2-3b
   in bf16, ``make_prefill_step`` and ``make_serve_step`` with
   ``shard=rules.shard_fn()``, logits bit-equal to the unsharded steps'
   on the same weights and tokens, the norm kernel launched and no
   plain version; (b) one AdamW step of its first 4 layers in f32 with
   ``shard=`` and ``grad_shardings=``, loss, first moments and
   parameters bit-equal to the unsharded step's, the norm's forward and
   backward launches as predicted; (c) ``launch.dryrun.run_one`` of
   llama3.2-3b x decode_32k on the 16x16 fake mesh in a subprocess with
   a 60 s limit, its three terms, dominant term and peak per device
   printed beside the torch version and where its DTensor API came from.

Prints each phase's seconds and peak device memory
(``torch.cuda.max_memory_allocated``), the card's name and power limit,
one JSON line of the kernels and, as its last line, ``{"ok": true,
"device": {...}}``. Exits non-zero without a result where torch sees no
CUDA device.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
PEAK_FLOPS = {torch.float32: 67e12,  # fp32 outside the tensor cores
              torch.bfloat16: 989e12}  # dense bf16 tensor cores
# Each element of a kernel's output must lie within ATOL + RTOL * |plain|
# of its plain version's, and within CAP. f32 (TF32 off): the summation
# order differs, nothing else. bf16: both accumulate in fp32 and round
# the output once, so they differ by at most one bf16 ulp, 2^-7 of the
# value.
TOL = {torch.float32: dict(atol=1e-4, rtol=0.0, cap=1e-4),
       torch.bfloat16: dict(atol=1e-5, rtol=2 ** -7, cap=2e-2)}
# rmsnorm, from the first readings on an H100 (PERF.md): f32 differs by at
# most 2 ulps (9.5e-7 at values up to 5.5), held to 8 ulps (2^-20
# relative) plus 1e-6; bf16 by one bf16 ulp, as above.
RMSNORM_TOL = {torch.float32: dict(atol=1e-6, rtol=2 ** -20, cap=1e-4),
               torch.bfloat16: TOL[torch.bfloat16]}
# rmsnorm's backward, dx: f32 is the difference of two fp32 terms of up to
# |u| r each (a few ulps of each, ~1e-6) after row sums taken in other
# orders (fp64 in the kernel), held to 1e-5 plus 8 ulps; bf16 to one bf16
# ulp, as above. dw (fp32, both versions): each column a sum of N terms
# in two orders, within (N - 1) 2^-24 of the sum of their magnitudes
# each; held to 2^-14 of that sum (N <= 1024) per column
RMSNORM_BWD_TOL = {torch.float32: dict(atol=1e-5, rtol=2 ** -20, cap=1e-4),
                   torch.bfloat16: TOL[torch.bfloat16]}
RMSNORM_DW_REL = 2 ** -14
# ssd_scan, y and the final state: both versions compute in fp32 in either
# input dtype, but sum the chunk's cumulative decay in different orders;
# at |cum| ~ 1e3 one ulp of cum_i - cum_j is ~1e-4, so an element is held
# to SSD_REL of its output's largest magnitude (first readings: at most
# 1.8e-4 of it, in the 2 x 700-token case below).
SSD_REL = 5e-4
# ssd_scan's backward: each gradient within SSD_REL of its own largest
# magnitude, for the same reason (first readings: at most 2.4e-4 of it, in
# f32 at 2 x 700); dx, dB and dC in bf16 also within one bf16 ulp of the
# element (TOL[bf16]'s rtol), since both versions round the fp32 gradient
# to bf16 once
SSD_BWD_NAMES = ("dx", "ddt", "dA", "dB", "dC", "dh0")
# the final hidden states of the 2-layer mamba2-370m parity check
MAMBA_PARITY_HIDDEN = 1e-4
SOURCES = {
    "paged_attention": ("src/repro_torch/csrc/paged_attention.cu",
                        "src/repro/kernels/paged_attention.py:78"),
    "paged_attention_int8": ("src/repro_torch/csrc/paged_attention_int8.cu",
                             "src/repro/kernels/paged_attention.py:70"),
    "chunked_prefill_attention": (
        "src/repro_torch/csrc/chunked_prefill_attention.cu",
        "src/repro/kernels/chunked_prefill_attention.py:90"),
    "rmsnorm": ("src/repro_torch/csrc/rmsnorm.cu",
                "src/repro/kernels/rmsnorm.py:23"),
    # the gradient of the same function (JAX differentiates the jnp
    # models/layers.py:26 with XLA's autodiff in training)
    "rmsnorm_bwd": ("src/repro_torch/csrc/rmsnorm.cu",
                    "src/repro/kernels/rmsnorm.py:23"),
    "ssd_scan": ("src/repro_torch/csrc/ssd_scan.cu",
                 "src/repro/kernels/ssd_scan.py:70"),
    # the gradient of the same function (JAX differentiates the jnp
    # models/mamba2.py:83 ssd_chunked with XLA's autodiff in training)
    "ssd_scan_bwd": ("src/repro_torch/csrc/ssd_scan_bwd.cu",
                     "src/repro/kernels/ssd_scan.py:70"),
}
ATTENTION_PATH = ("paged_attention", "chunked_prefill_attention", "rmsnorm")


@dataclasses.dataclass(frozen=True)
class ServedPath:
    """One served path and its settings in the serve, profile and parity
    phases."""
    arch: str
    kernels: tuple = ATTENTION_PATH     # the kernels it runs (and no other)
    kv_quant: bool = False              # int8 KV pages
    kv_layout: str = "paged"            # the fused engine's KV layout
    # served by the serve script as a user runs it; otherwise through the
    # replica that ``_replica`` builds
    script: bool = False
    # prompts longer than the window (``_long_prompt_requests``): the
    # script's mix, prompts of 32-1023 tokens, would leave a 1024-token
    # window masking nothing
    long_prompts: bool = False
    # (kernel, variant) pairs of ``ops.variants`` that its serve run must
    # have launched
    variants: tuple = ()
    # (decode context, prefill start) of the profiled iterations
    profile_at: tuple = (1000, 0)
    # the two layers of its parity check, the limit on their final hidden
    # states, and whether two sampled ids may differ at a logged near-tie
    # (``_ids_agree``); otherwise they must be equal
    parity_layers: tuple = (0, 1)
    parity_hidden: float = 1e-4
    near_tie: bool = False


PATHS = {"llama3.2-3b": ServedPath("llama3.2-3b", script=True),
         # the dense slot cache: decode rows through the decode kernel over
         # 256-token pages that are views of the slots' rows, prefill rows
         # through the prefill kernel over their slots' 2048 positions
         "llama3.2-3b dense": ServedPath(
             "llama3.2-3b", script=True, kv_layout="dense",
             variants=(("paged_attention", (128, 256)),
                       ("chunked_prefill_attention", (128, None)))),
         "mamba2-370m": ServedPath("mamba2-370m", ("rmsnorm", "ssd_scan"),
                                   script=True),
         # the int8 pages are written from inputs that differ by the
         # kernels' summation order (about 1e-6), so a value on a rounding
         # boundary lands one int8 step apart, moving a score by up to a
         # scale (max|k| / 127) times |q| D^-1/2: the parity limit is wider
         "llama3.2-3b int8": ServedPath(
             "llama3.2-3b", ("paged_attention_int8",
                             "chunked_prefill_attention", "rmsnorm"),
             kv_quant=True, parity_hidden=1e-3),
         "qwen3-moe-30b-a3b": ServedPath("qwen3-moe-30b-a3b"),
         "llama3-8b": ServedPath("llama3-8b"),
         # the prefill kernel at D 256 with the window (prefill rows and
         # windowed decode rows), the decode kernel at D 256 (the global
         # layers); profiled past the window; its parity check takes its
         # first sliding-window layer and its first global layer
         "gemma3-4b": ServedPath(
             "gemma3-4b", long_prompts=True,
             variants=(("chunked_prefill_attention", (256, 1024)),
                       ("paged_attention", (256, 64))),
             profile_at=(2000, 1000), parity_layers=(0, 5), near_tie=True)}


# the head layouts of the families ported since the MoE slice, which the
# bf16 cases of llama3.2-3b's layout (H24 KV8 D128, G 3) do not cover:
# (family, H, KV, head_dim)
NEW_HEAD_LAYOUTS = (("qwen3-moe-30b-a3b", 32, 4, 64),
                    ("llama3-8b", 32, 8, 128),
                    ("qwen-7b", 32, 32, 128),
                    ("starcoder2-15b", 48, 4, 128))

# the timed shapes whose numbers go into the kernels line
DECODE_MAIN = "bf16 B8 H24 KV8 D128"
PREFILL_MAIN = "bf16 P4 C512 H24 KV8 D128 S1024"

# gemma3-4b's attention (H8 KV4 D256, G 2, window 1024), which the
# sliding-window slice added: every prefill row and every windowed decode
# row go through the prefill kernel (decode rows as C = 1 chunks over the
# gathered view), the global layers' decode rows through the decode
# kernel. Each case's rows alone equal their rows of the batch, bit for
# bit.
GEMMA_WINDOW = 1024
GEMMA_DECODE = "bf16 B8 H8 KV4 D256 (gemma3-4b, G=2)"


# llama3.2-3b's long_500k variant (H24 KV8 D128, every layer sliding with
# a window of 8192), which the reclaim phase serves: chunks of up to 2048
# at offsets past the window over a 9216-token view (the window cuts both
# rows: queries up to 9215 and 8999), rows alone against the batch
LONG_WINDOW = 8192
LONG_PREFILL = (f"bf16 P2 C2048 H24 KV8 D128 S9216 window {LONG_WINDOW} "
                f"(llama3.2-3b long_500k)")
# windowed decode rows over views with -1 holes: (layout, H, KV, D, table
# width in 64-token pages, window, each row's length)
HOLE_CASES = (("H8 KV4 D256 (gemma3-4b)", 8, 4, 256, 32, GEMMA_WINDOW,
               [2048, 1500, 1100, 1024, 1025, 2000, 1087, 700]),
              ("H24 KV8 D128 (llama3.2-3b long_500k)", 24, 8, 128, 144,
               LONG_WINDOW, [9216, 9024, 9000, 8193, 8192, 8256, 9100,
                             700]))


def _gemma_prefill_cases():
    """(dtype, label, (B, C, H, KV, D, S), offsets, chunk lengths,
    window): a 4-row bucket of 512-token chunks over a 2048-token view,
    ragged offsets, one pad row, without and with the window; and 8
    windowed decode rows (C = 1) over a 2048-token view, one of them a
    pad row."""
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        for window in (None, GEMMA_WINDOW):
            cases.append((dtype, f"{_label(dtype)} P4 C512 H8 KV4 D256 S2048"
                          + (f" window {window}" if window else "")
                          + " (gemma3-4b)", (4, 512, 8, 4, 256, 2048),
                          [0, 700, 1500, 0], [512, 512, 300, 0], window))
        cases.append((dtype, f"{_label(dtype)} P8 C1 H8 KV4 D256 S2048 "
                      f"window {GEMMA_WINDOW} (gemma3-4b windowed decode)",
                      (8, 1, 8, 4, 256, 2048),
                      [2047, 1500, 1023, 1024, 5, 0, 1800, 900],
                      [1, 1, 1, 1, 1, 0, 1, 1], GEMMA_WINDOW))
    return cases


class PhaseError(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseError(msg)


def _free_device_memory() -> None:
    """Return the memory of engines dropped by the caller to the card:
    an engine and its pool refer to each other (``bind_runtime``), so only
    the cycle collector frees them."""
    gc.collect()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------- timing

_flush_buf = None
SPIN_MS = 5.0           # device time queued ahead of each timed call
_cycles_per_ms = None


def _spin(ms: float) -> None:
    """Keep the device busy for about ``ms`` ms: while it spins, the host
    queues the timed call's launches, so the events that bracket the call
    read device time only, not the host's time to issue the launches."""
    global _cycles_per_ms
    if _cycles_per_ms is None:
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        torch.cuda._sleep(10 ** 6)
        e1.record()
        torch.cuda.synchronize()
        _cycles_per_ms = 10 ** 6 / e0.elapsed_time(e1)
    torch.cuda._sleep(int(_cycles_per_ms * ms))


def _flush_l2() -> None:
    """Overwrite a buffer four times the 50 MB L2, so the next launch
    finds its inputs in device memory, as a layer of the model does."""
    global _flush_buf
    if _flush_buf is None:
        _flush_buf = torch.empty(200 * 2 ** 20, dtype=torch.uint8,
                                 device="cuda")
    _flush_buf.zero_()


def time_ms(fn, reps: int = 20, warmup: int = 3,
            spin_ms: float = SPIN_MS) -> float:
    """Median device time of one call of ``fn``, cold L2, CUDA events,
    with the call queued behind a spin (``_spin``) of ``spin_ms`` (longer
    for a plain version of many launches). A sample whose call took the
    host longer than the spin to queue is dropped, since its events may
    hold host time, and taken again; fails after ``reps`` such samples,
    as it would if ``fn`` waited on the device."""
    for _ in range(warmup):
        fn()
    # the spin's calibration and the flush buffer's allocation wait on the
    # device: do them once here, not inside a timed call's issue window
    _spin(spin_ms)
    _flush_l2()
    times, stalls = [], 0
    while len(times) < reps:
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _spin(spin_ms)
        _flush_l2()
        e0.record()
        fn()
        e1.record()
        issue_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        if issue_ms >= spin_ms:
            stalls += 1
            check(stalls <= reps, f"timing: the host took {issue_ms:.2f} ms "
                  f"to queue one call, longer than the {spin_ms} ms spin, "
                  f"{stalls} times")
            continue
        times.append(e0.elapsed_time(e1))
    return float(np.median(times))


def _call_ms(fn, reps: int = 5) -> float:
    """Median ms of one call of ``fn`` from an idle device, between CUDA
    events recorded before and after it: the device's time and the gaps
    in which it waits for the host to queue the call's launches. For a
    call of many small launches (the encoder's), where
    ``time_ms``'s spin cannot cover the host's queueing."""
    fn()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
    return float(np.median(times))


def bound_ms(nbytes: float, flops: float, dtype) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------- phase 1

def phase_build() -> float:
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    built = build.build()
    secs = time.perf_counter() - t0
    print(f"[build] {built or 'nothing (libraries current)'} in "
          f"{secs:.1f} s")
    for name, log in build.build_logs.items():
        for line in log.splitlines():
            if any(w in line for w in ("Function properties", "registers",
                                       "spill")):
                print(f"[build] {name}: {line.strip()}")
    return secs


# ---------------------------------------------------------------- phase 2

def _paged_case(rng, dtype, B, H, KV, D, page, n_pages, lens, holes):
    """Decode inputs: ragged ``lens``; ``holes`` lists (row, page index)
    table entries set to -1 (a row of all -1 is an inactive slot)."""
    P = B * n_pages + 3
    dev = "cuda"
    q = torch.from_numpy(rng.standard_normal((B, H, D), np.float32))
    kp = torch.from_numpy(rng.standard_normal((P, page, KV, D), np.float32))
    vp = torch.from_numpy(rng.standard_normal((P, page, KV, D), np.float32))
    bt = np.full((B, n_pages), -1, np.int32)
    perm = rng.permutation(P)
    for b in range(B):
        n = -(-lens[b] // page)
        bt[b, :n] = perm[b * n_pages:b * n_pages + n]
    for b, pi in holes:
        bt[b, pi] = -1
    return (q.to(dev, dtype), kp.to(dev, dtype), vp.to(dev, dtype),
            torch.from_numpy(bt).to(dev),
            torch.tensor(lens, dtype=torch.int32, device=dev))


def _live_tokens(bt, lens, page: int) -> int:
    """Tokens of pages in the table below each row's length."""
    bt_h, lens_h = bt.cpu().numpy(), lens.cpu().numpy()
    live = 0
    for b in range(bt_h.shape[0]):
        for pi in range(bt_h.shape[1]):
            if bt_h[b, pi] >= 0:
                live += max(0, min(page, lens_h[b] - pi * page))
    return live


def _paged_work(q, kp, bt, lens, quant: bool = False):
    """Bytes and flops of the live work: the K/V rows of the live tokens
    (with int8 pages, ``quant``, their bf16 scales too: one each per token
    and kv-head), q, the output, the table and lens; 4 flops per (head,
    element), and with int8 pages the dequantization's product per page
    element."""
    B, H, D = q.shape
    page, KV = kp.shape[1], kp.shape[2]
    live = _live_tokens(bt, lens, page)
    row_bytes = D * kp.element_size() + (2 if quant else 0)
    nbytes = 2 * live * KV * row_bytes + 2 * B * H * D * q.element_size() \
        + bt.numel() * 4 + B * 4
    flops = 4.0 * live * H * D + (2.0 * live * KV * D if quant else 0.0)
    return nbytes, flops


def _gathered(k_pages, v_pages, bt, lens, H):
    """The pages of each row as a dense [B, H, n*page, D] view (kv heads
    repeated to H) and the visibility mask, for the SDPA yardstick."""
    B, n = bt.shape
    page, KV, D = k_pages.shape[1:]
    idx = bt.clamp_min(0).long()
    G = H // KV

    def dense(p):
        x = p[idx].reshape(B, n * page, KV, D).transpose(1, 2)
        return x.repeat_interleave(G, dim=1).contiguous()
    pos = torch.arange(n * page, device=bt.device)
    mask = (pos[None] < lens[:, None]) \
        & (bt >= 0).repeat_interleave(page, dim=1)
    return dense(k_pages), dense(v_pages), mask[:, None, None, :]


def _prefill_case(rng, dtype, B, C, H, KV, D, S, offs, reals):
    dev = "cuda"
    q = torch.from_numpy(rng.standard_normal((B, C, H, D), np.float32))
    k = torch.from_numpy(rng.standard_normal((B, S, KV, D), np.float32))
    v = torch.from_numpy(rng.standard_normal((B, S, KV, D), np.float32))
    kv_lens = [o + r if r else 0 for o, r in zip(offs, reals)]
    return (q.to(dev, dtype), k.to(dev, dtype), v.to(dev, dtype),
            torch.tensor(offs, dtype=torch.int32, device=dev),
            torch.tensor(kv_lens, dtype=torch.int32, device=dev))


def _prefill_mask(C, S, q_offsets, kv_lens, window=None):
    qpos = q_offsets.long()[:, None] + torch.arange(C, device="cuda")
    kpos = torch.arange(S, device="cuda")
    mask = (kpos[None, None] <= qpos[:, :, None]) \
        & (kpos[None, None] < kv_lens.long()[:, None, None])
    if window is not None:
        mask &= qpos[:, :, None] - kpos[None, None] < window
    return mask                                            # [B, C, S]


def _prefill_work(q, k, q_offsets, kv_lens, window=None):
    """Bytes and flops of the live work: visible (query, key) pairs, the
    key rows any query sees, q and the output."""
    B, C, H, D = q.shape
    S, KV = k.shape[1], k.shape[2]
    es = q.element_size()
    mask = _prefill_mask(C, S, q_offsets, kv_lens, window)
    pairs = int(mask.sum())
    key_rows = int(mask.any(dim=1).sum())
    nbytes = 2 * key_rows * KV * D * es + 2 * B * C * H * D * es + 8 * B
    return nbytes, 4.0 * pairs * H * D


def _compare(name, label, dtype, got, want, tol=None):
    """Max |kernel - plain|; fails unless every element is within the
    limit ``tol`` (by default the attention kernels' ``TOL[dtype]``)."""
    diff = (got.float() - want.float()).abs()
    t = TOL[dtype] if tol is None else tol
    limit = (t["atol"] + t["rtol"] * want.float().abs()).clamp(max=t["cap"])
    worst = float((diff / limit).max())
    finite = bool(torch.isfinite(got.float()).all())
    err = float(diff.max())
    check(finite and worst <= 1.0,
          f"{name} [{label}]: |kernel - plain| up to {worst:.3g} times its "
          f"limit {t} (max {err:.3g}), finite={finite}")
    return err, worst


def phase_kernels() -> dict:
    from repro_torch.kernels import ref
    from repro_torch.kernels.chunked_prefill_attention import \
        chunked_prefill_attention_cuda

    import torch.nn.functional as F

    rng = np.random.default_rng(0)
    head = {}

    # ---- paged decode: the engine's decode batch at full width
    _kernels_paged(head, rng, quant=False)
    _kernels_dense_pages(np.random.default_rng(6))

    # ---- chunked prefill: a 4-row bucket of 512-token chunks over a
    # 16-page view, ragged offsets and one pad row
    for dtype, label, shape, offs, reals, window in [
            (torch.float32, "f32 P4 C512 H24 KV8 D128 S1024",
             (4, 512, 24, 8, 128, 1024), [0, 128, 300, 0],
             [512, 512, 77, 0], None),
            (torch.bfloat16, PREFILL_MAIN,
             (4, 512, 24, 8, 128, 1024), [0, 128, 300, 0],
             [512, 512, 77, 0], None),
            (torch.float32, "f32 P2 C200 H8 KV8 D64 S512 (G=1)",
             (2, 200, 8, 8, 64, 512), [37, 0], [200, 150], None),
            (torch.float32, "f32 P2 C128 H24 KV8 D128 S512 window 100",
             (2, 128, 24, 8, 128, 512), [300, 5], [128, 100], 100),
            (torch.bfloat16, "bf16 P1 C1024 H24 KV8 D128 S1024 (the "
             "profile's prefill)", (1, 1024, 24, 8, 128, 1024), [0], [1024],
             None)] + [
            (torch.bfloat16, f"bf16 P4 C512 H{H} KV{KV} D{D} S1024 ({arch}, "
             f"G={H // KV})", (4, 512, H, KV, D, 1024), [0, 128, 300, 0],
             [512, 512, 77, 0], None)
            for arch, H, KV, D in NEW_HEAD_LAYOUTS] \
            + _gemma_prefill_cases() + [
            (torch.bfloat16, LONG_PREFILL, (2, 2048, 24, 8, 128, 9216),
             [7168, 8192], [2048, 808], LONG_WINDOW)]:
        B, C, H, KV, D, S = shape
        q, k, v, qo, kl = _prefill_case(rng, dtype, B, C, H, KV, D, S,
                                        offs, reals)
        got = chunked_prefill_attention_cuda(q, k, v, qo, kl, window=window)
        want = ref.chunked_prefill_attention_ref(q, k, v, qo, kl,
                                                 window=window)
        torch.cuda.synchronize()
        err, worst = _compare("chunked_prefill_attention", label, dtype,
                              got, want)
        pad = [b for b, r in enumerate(reals) if r == 0]
        check(all(bool((got[b] == 0).all()) for b in pad),
              "chunked_prefill_attention: a pad row must give 0")
        if label in (PREFILL_MAIN, LONG_PREFILL) or D == 256:
            # each row alone is the same row of the batch, bit for bit
            for b in range(B):
                alone = chunked_prefill_attention_cuda(
                    q[b:b + 1], k[b:b + 1], v[b:b + 1], qo[b:b + 1],
                    kl[b:b + 1], window=window)
                check(torch.equal(alone, got[b:b + 1]),
                      f"chunked_prefill_attention [{label}]: row {b} alone "
                      f"differs from the same row in the batch")
            print(f"[kernels] chunked_prefill_attention {label}: each row "
                  f"alone equals its row of the batch, bit for bit")
        ms = time_ms(lambda: chunked_prefill_attention_cuda(
            q, k, v, qo, kl, window=window))
        plain = time_ms(lambda: ref.chunked_prefill_attention_ref(
            q, k, v, qo, kl, window=window))
        G = H // KV
        qd = q.transpose(1, 2)
        kd = k.transpose(1, 2).repeat_interleave(G, dim=1).contiguous()
        vd = v.transpose(1, 2).repeat_interleave(G, dim=1).contiguous()
        mask = _prefill_mask(C, S, qo, kl, window)[:, None]
        lib = time_ms(lambda: F.scaled_dot_product_attention(
            qd, kd, vd, attn_mask=mask))
        nbytes, flops = _prefill_work(q, k, qo, kl, window)
        bms, by = bound_ms(nbytes, flops, dtype)
        print(f"[kernels] chunked_prefill_attention {label}: {ms:.4f} ms, "
              f"plain {plain:.4f} ms, sdpa {lib:.4f} ms, bound {bms:.4f} "
              f"ms ({by}), max err {err:.3g} ({worst:.2f} of the limit)")
        if label == PREFILL_MAIN:
            head["chunked_prefill_attention"] = dict(
                ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bms,
                bound_by=by, max_abs_err=err)

    # the static mode (one offset for every row) through the same kernel
    from repro_torch.kernels import ops
    q, k, v, _, _ = _prefill_case(rng, torch.float32, 2, 96, 24, 8, 128,
                                  256, [0, 0], [1, 1])
    got = ops.chunked_prefill_attention(q, k, v, q_offset=100, kv_len=196)
    with ops.plain_versions():
        want = ops.chunked_prefill_attention(q, k, v, q_offset=100,
                                             kv_len=196)
    torch.cuda.synchronize()
    err, _ = _compare("chunked_prefill_attention", "static mode",
                      torch.float32, got, want)
    # timed as the static call launches it: the one offset and length
    # broadcast to every row
    qo = torch.full((2,), 100, dtype=torch.int32, device="cuda")
    kl = torch.full((2,), 196, dtype=torch.int32, device="cuda")
    ms = time_ms(lambda: chunked_prefill_attention_cuda(q, k, v, qo, kl))
    plain = time_ms(lambda: ref.chunked_prefill_attention_ref(q, k, v, qo,
                                                              kl))
    qd = q.transpose(1, 2)
    kd = k.transpose(1, 2).repeat_interleave(3, dim=1).contiguous()
    vd = v.transpose(1, 2).repeat_interleave(3, dim=1).contiguous()
    mask = _prefill_mask(96, 256, qo, kl)[:, None]
    lib = time_ms(lambda: F.scaled_dot_product_attention(
        qd, kd, vd, attn_mask=mask))
    bms, by = bound_ms(*_prefill_work(q, k, qo, kl), torch.float32)
    print(f"[kernels] chunked_prefill_attention static mode f32 P2 C96 H24 "
          f"KV8 D128 S256 (offset 100, length 196): {ms:.4f} ms, plain "
          f"{plain:.4f} ms, sdpa {lib:.4f} ms, bound {bms:.4f} ms ({by}), "
          f"max err {err:.3g}")
    _kernels_windowed_holes(np.random.default_rng(5))
    _kernels_paged(head, np.random.default_rng(4), quant=True)
    _kernels_rmsnorm(head)
    _kernels_rmsnorm_bwd(head)
    _kernels_ssd_scan(head)
    _kernels_ssd_scan_bwd(head)
    return head


def _kernels_windowed_holes(rng) -> None:
    """Windowed decode rows (C = 1) over a view gathered from pages whose
    table has -1 holes where SWA reclamation freed the blocks that slid
    out of the window, at each layout of ``HOLE_CASES``: the holes read
    page 0, which the window masks, so the kernel's output equals its
    output over the same table without holes, bit for bit, and the plain
    version's within ``TOL``; each row alone equals its row of the batch,
    bit for bit. A row about to attend from position ``len - 1`` had
    ``len - 1`` tokens after the iteration before, whose reclaim freed
    its blocks of positions <= len - 1 - window. f32 and bf16."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.chunked_prefill_attention import \
        chunked_prefill_attention_cuda
    from repro_torch.models.transformer import PagedAttnCache, _paged_view

    page = 64
    for layout, H, KV, D, n_pages, W, lens in HOLE_CASES:
        B = len(lens)
        for dtype in (torch.float32, torch.bfloat16):
            q, kp, vp, bt, ln = _paged_case(rng, dtype, B, H, KV, D, page,
                                            n_pages, lens, [])
            holes = bt.clone()
            dead = [max(0, (n - W) // page) for n in lens]
            for b, n in enumerate(dead):
                holes[b, :n] = -1
            qo = ln - 1
            q1 = q[:, None].contiguous()
            views = [_paged_view(PagedAttnCache(kp, vp), t)
                     for t in (holes, bt)]
            outs = [chunked_prefill_attention_cuda(q1, k, v, qo, ln,
                                                   window=W)
                    for k, v in views]
            want = ref.chunked_prefill_attention_ref(q1, *views[0], qo, ln,
                                                     window=W)
            torch.cuda.synchronize()
            label = (f"{_label(dtype)} B{B} C1 {layout} S{n_pages * page} "
                     f"window {W}, holes")
            err, worst = _compare("chunked_prefill_attention", label, dtype,
                                  outs[0], want)
            check(torch.equal(outs[0], outs[1]),
                  f"chunked_prefill_attention [{label}]: the table with -1 "
                  f"holes gives another output than the table without")
            k, v = views[0]
            for b in range(B):
                alone = chunked_prefill_attention_cuda(
                    q1[b:b + 1], k[b:b + 1], v[b:b + 1], qo[b:b + 1],
                    ln[b:b + 1], window=W)
                check(torch.equal(alone, outs[0][b:b + 1]),
                      f"chunked_prefill_attention [{label}]: row {b} alone "
                      f"differs from the same row in the batch")
            print(f"[kernels] chunked_prefill_attention {label}: "
                  f"{sum(dead)} dead blocks as -1 holes give the output of "
                  f"the full table, each row alone its row of the batch, "
                  f"bit for bit; max err {err:.3g} ({worst:.2f} of the "
                  f"limit)")
            del q, kp, vp, views, outs, want, k, v


def _quantized_pages(k_pages, v_pages):
    """int8 pages and bf16 scales made by the port's write path
    (``_quantize``) from float pages."""
    from repro_torch.models.transformer import _quantize
    k8, ks = _quantize(k_pages)
    v8, vs = _quantize(v_pages)
    return k8, v8, ks, vs


def _kernels_paged(head: dict, rng, quant: bool) -> None:
    """A decode batch at full width (ragged lens, -1 holes, a row whose
    table is all -1) through ``paged_attention`` in f32 and bf16 and at
    G = 1 and G = 8, or with ``quant`` through ``paged_attention_int8``
    on the same kind of inputs, the pages quantized by ``_quantize``, with
    an f32 and a bf16 query and at G = 1; both at gemma3-4b's D 256 (H8
    KV4); then, in bf16, one row of 1500 tokens and one of 4096 (64 pages,
    32 splits). Both int8 versions
    dequantize exactly in fp32, so the limits are ``TOL``'s either way.
    On the main batch and the bf16 D 256 batch the split-K kernel's
    invariance is checked bit for bit: each row served alone equals its
    row of the batch, and the 32-page table widened to 64 columns of -1
    gives the same output."""
    import torch.nn.functional as F

    from repro_torch.kernels import ref
    from repro_torch.kernels.paged_attention import paged_attention_cuda
    from repro_torch.kernels.paged_attention_int8 import \
        paged_attention_int8_cuda

    name = "paged_attention_int8" if quant else "paged_attention"
    lens = [2048, 1500, 1, 700, 64, 1023, 333, 900]
    holes = [(2, 0)] + [(5, pi) for pi in range(32)] + [(1, 7)]
    batch = (32, lens, holes)
    cases = [(torch.float32, "f32 B8 H24 KV8 D128", (8, 24, 8, 128), batch),
             (torch.bfloat16, DECODE_MAIN, (8, 24, 8, 128), batch),
             (torch.float32, "f32 B8 H8 KV8 D64 (G=1)", (8, 8, 8, 64),
              batch)]
    if not quant:
        cases.append((torch.float32, "f32 B8 H32 KV4 D128 (G=8)",
                      (8, 32, 4, 128), batch))
        cases += [(torch.bfloat16, f"bf16 B8 H{H} KV{KV} D{D} ({arch}, "
                   f"G={H // KV})", (8, H, KV, D), batch)
                  for arch, H, KV, D in NEW_HEAD_LAYOUTS]
    # gemma3-4b's global layers, D 256, with both page types
    cases += [(torch.float32, "f32 B8 H8 KV4 D256 (gemma3-4b, G=2)",
               (8, 8, 4, 256), batch),
              (torch.bfloat16, GEMMA_DECODE, (8, 8, 4, 256), batch)]
    cases += [(torch.bfloat16, "bf16 B1 H24 KV8 D128, 1500 tokens",
               (1, 24, 8, 128), (32, [1500], [])),
              (torch.bfloat16, "bf16 B1 H24 KV8 D128, one row of 4096 "
               "tokens (64 pages)", (1, 24, 8, 128), (64, [4096], []))]
    for dtype, label, shape, (n_pages, row_lens, row_holes) in cases:
        B, H, KV, D = shape
        q, kp, vp, bt, ln = _paged_case(rng, torch.float32 if quant
                                        else dtype, B, H, KV, D, 64,
                                        n_pages, row_lens, row_holes)
        if quant:
            q = q.to(dtype)
            k8, v8, ks, vs = _quantized_pages(kp, vp)
            args = (q, k8, v8, ks, vs, bt, ln)
            kernel = paged_attention_int8_cuda
            plain_args = (q, k8, v8, bt, ln, ks, vs)
            # the yardstick: SDPA over the view dequantized beforehand (no
            # single PyTorch call takes int8 pages), the dequant untimed
            kp, vp = ((p.float() * s.float()[..., None]).to(dtype)
                      for p, s in ((k8, ks), (v8, vs)))
            work = _paged_work(q, k8, bt, ln, quant=True)
            lib_label = "sdpa over the dequantized view"
        else:
            args = plain_args = (q, kp, vp, bt, ln)
            kernel = paged_attention_cuda
            work = _paged_work(q, kp, bt, ln)
            lib_label = "sdpa"
        got = kernel(*args)
        want = ref.paged_attention_ref(*plain_args)
        torch.cuda.synchronize()
        err, worst = _compare(name, label, dtype, got, want)
        if B == 8:
            check(bool((got[5] == 0).all()),
                  f"{name}: a row whose table is all -1 must give 0")
        if label in (DECODE_MAIN, GEMMA_DECODE):
            def call(q_, bt_, ln_):
                return kernel(q_, *args[1:-2], bt_, ln_)
            for b in range(B):
                check(torch.equal(call(q[b:b + 1], bt[b:b + 1],
                                       ln[b:b + 1]), got[b:b + 1]),
                      f"{name} [{label}]: row {b} alone differs from the "
                      f"same row in the batch")
            wide = torch.full((B, 2 * n_pages), -1, dtype=torch.int32,
                              device="cuda")
            wide[:, :n_pages] = bt
            check(torch.equal(call(q, wide, ln), got),
                  f"{name} [{label}]: the table widened to {2 * n_pages} "
                  f"columns of -1 gives another output")
            print(f"[kernels] {name} {label}: each row alone equals its row "
                  f"of the batch, and the {n_pages}-page table equals it "
                  f"widened to {2 * n_pages} columns, bit for bit")
        ms = time_ms(lambda: kernel(*args))
        plain = time_ms(lambda: ref.paged_attention_ref(*plain_args))
        kd, vd, mask = _gathered(kp, vp, bt, ln, H)
        qd = q[:, :, None, :]
        lib = time_ms(lambda: F.scaled_dot_product_attention(
            qd, kd, vd, attn_mask=mask))
        bms, by = bound_ms(*work, dtype)
        print(f"[kernels] {name} {label}: {ms:.4f} ms, plain {plain:.4f} "
              f"ms, {lib_label} {lib:.4f} ms, bound {bms:.4f} ms ({by}), "
              f"max err {err:.3g} ({worst:.2f} of the limit)")
        if label == DECODE_MAIN:
            head[name] = dict(ms=ms, plain_ms=plain, library_ms=lib,
                              bound_ms=bms, bound_by=by, max_abs_err=err)


# the dense layout's decode: 8 slots of 2048 positions read as 8 pages of
# 256 tokens each (one page a split), at llama3.2-3b's heads and at D 64,
# G 1 with 16 kv-heads: (label, H, KV, D)
DENSE_PAGE = 256
DENSE_DECODE_CASES = (("B8 H24 KV8 D128 (llama3.2-3b, G=3)", 24, 8, 128),
                      ("B8 H16 KV16 D64 (G=1)", 16, 16, 64))


def _kernels_dense_pages(rng) -> None:
    """The decode kernel over the dense layout's pages, as
    ``models/transformer.py::_attn_pallas`` hands them over: each slot's
    2048-position row of a ``[9, 2048, KV, D]`` cache (8 slots and the
    sink row) viewed as 8 pages of 256 tokens, an iota block table,
    ragged lengths and an empty slot, in f32 and bf16 at
    ``DENSE_DECODE_CASES``: against the plain version within ``TOL``,
    each row alone equal to its row of the batch bit for bit, with its
    time, the plain version's, SDPA's over the same rows and the
    bound."""
    import torch.nn.functional as F

    from repro_torch.kernels import ref
    from repro_torch.kernels.paged_attention import (paged_attention_cuda,
                                                     plan_splits)

    B, n_pages, page = 8, 2048 // DENSE_PAGE, DENSE_PAGE
    lens = [2048, 1500, 1, 700, 256, 257, 1023, 0]
    check(plan_splits(n_pages, page) == (1, n_pages),
          f"paged_attention: 256-token pages plan "
          f"{plan_splits(n_pages, page)}, not one page a split")
    for layout, H, KV, D in DENSE_DECODE_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            label = f"{_label(dtype)} {layout}, {page}-token pages (dense)"
            cache_k, cache_v = (torch.from_numpy(rng.standard_normal(
                (B + 1, n_pages * page, KV, D), np.float32)).to("cuda",
                                                                dtype)
                for _ in range(2))
            q = torch.from_numpy(rng.standard_normal(
                (B, H, D), np.float32)).to("cuda", dtype)
            kp = cache_k[:B].view(B * n_pages, page, KV, D)
            vp = cache_v[:B].view(B * n_pages, page, KV, D)
            bt = torch.arange(B * n_pages, dtype=torch.int32,
                              device="cuda").view(B, n_pages)
            ln = torch.tensor(lens, dtype=torch.int32, device="cuda")
            got = paged_attention_cuda(q, kp, vp, bt, ln)
            want = ref.paged_attention_ref(q, kp, vp, bt, ln)
            torch.cuda.synchronize()
            err, worst = _compare("paged_attention", label, dtype, got, want)
            check(bool((got[7] == 0).all()),
                  f"paged_attention [{label}]: an empty slot must give 0")
            for b in range(B):
                alone = paged_attention_cuda(q[b:b + 1], kp, vp,
                                             bt[b:b + 1], ln[b:b + 1])
                check(torch.equal(alone, got[b:b + 1]),
                      f"paged_attention [{label}]: row {b} alone differs "
                      f"from the same row in the batch")
            ms = time_ms(lambda: paged_attention_cuda(q, kp, vp, bt, ln))
            plain = time_ms(lambda: ref.paged_attention_ref(q, kp, vp, bt,
                                                            ln))
            kd, vd, mask = _gathered(kp, vp, bt, ln, H)
            qd = q[:, :, None, :]
            lib = time_ms(lambda: F.scaled_dot_product_attention(
                qd, kd, vd, attn_mask=mask))
            bms, by = bound_ms(*_paged_work(q, kp, bt, ln), dtype)
            print(f"[kernels] paged_attention {label}: {ms:.4f} ms, plain "
                  f"{plain:.4f} ms, sdpa {lib:.4f} ms, bound {bms:.4f} ms "
                  f"({by}), max err {err:.3g} ({worst:.2f} of the limit); "
                  f"each row alone equals its row of the batch, bit for "
                  f"bit")
            del cache_k, cache_v, kp, vp, kd, vd


def _label(dtype) -> str:
    return "f32" if dtype == torch.float32 else "bf16"


# the d_model of every served path: llama3.2-3b, mamba2-370m (and
# whisper-medium), qwen3-moe-30b-a3b, llama3-8b, gemma3-4b, internvl2-76b
SERVED_WIDTHS = (3072, 1024, 2048, 4096, 2560, 8192)


def _kernels_rmsnorm(head: dict) -> None:
    """The norms of every served path: a decode batch [8, D] and a
    prefill chunk [1024, D] at the widths of llama3.2-3b (3072),
    mamba2-370m and whisper-medium (1024; whisper's encoder rows are
    [1500, 1024] in f32), qwen3-moe-30b-a3b (2048), llama3-8b (4096),
    gemma3-4b (2560) and internvl2-76b (8192);
    then rows whose width is not a multiple of 16 bytes; then at each
    served width rows alone, [1, D], against the same rows in [8, D] and
    in [1024, D], bit for bit."""
    import torch.nn.functional as F

    from repro_torch.kernels import ref
    from repro_torch.kernels.rmsnorm import plan, rmsnorm_cuda

    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    cases = [(dtype, shape) for shape in ((8, 3072), (1024, 3072),
                                          (1024, 1024), (8, 2048),
                                          (1024, 2048), (8, 4096),
                                          (1024, 4096), (8, 2560),
                                          (1024, 2560), (1500, 1024),
                                          (8, 8192), (1024, 8192))
             for dtype in (torch.float32, torch.bfloat16)]
    cases += [(torch.bfloat16, (5, 1001)), (torch.float32, (3, 77))]
    for dtype, (N, D) in cases:
        label = f"{_label(dtype)} [{N}, {D}]"
        x = torch.randn((N, D), generator=gen, device="cuda").to(dtype)
        w = (0.1 * torch.randn(D, generator=gen, device="cuda")).to(dtype)
        got = rmsnorm_cuda(x, w, 1e-5)
        want = ref.rmsnorm_ref(x, w, 1e-5)
        torch.cuda.synchronize()
        err, worst = _compare("rmsnorm", label, dtype, got, want,
                              RMSNORM_TOL[dtype])
        ms = time_ms(lambda: rmsnorm_cuda(x, w, 1e-5))
        plain = time_ms(lambda: ref.rmsnorm_ref(x, w, 1e-5))
        w1 = 1.0 + w          # the library's weight, made outside the timing
        lib = time_ms(lambda: F.rms_norm(x, (D,), weight=w1, eps=1e-5))
        # each element read once and written once, ~4 fp32 flops each
        bms, by = bound_ms((2 * N * D + D) * x.element_size(), 4.0 * N * D,
                           torch.float32)
        print(f"[kernels] rmsnorm {label} {tuple(plan(D, dtype))}: "
              f"{ms:.4f} ms, plain {plain:.4f} ms, F.rms_norm {lib:.4f} ms, "
              f"bound {bms:.4f} ms ({by}), max err {err:.3g} ({worst:.2f} "
              f"of the limit)")
        if label == "bf16 [1024, 3072]":
            head["rmsnorm"] = dict(ms=ms, plain_ms=plain, library_ms=lib,
                                   bound_ms=bms, bound_by=by,
                                   max_abs_err=err)
    for dtype in (torch.float32, torch.bfloat16):
        for D in SERVED_WIDTHS:
            x = torch.randn((1024, D), generator=gen, device="cuda").to(dtype)
            w = (0.1 * torch.randn(D, generator=gen, device="cuda")).to(dtype)
            full = rmsnorm_cuda(x, w, 1e-5)
            eight = rmsnorm_cuda(x[:8].contiguous(), w, 1e-5)
            check(torch.equal(eight, full[:8]),
                  f"rmsnorm {_label(dtype)} D {D}: [8, D] differs from the "
                  f"same rows of [1024, D]")
            for r in range(8):
                check(torch.equal(rmsnorm_cuda(x[r:r + 1], w, 1e-5),
                                  full[r:r + 1]),
                      f"rmsnorm {_label(dtype)} D {D}: row {r} alone differs "
                      f"from the same row in [1024, D]")
    torch.cuda.synchronize()
    print(f"[kernels] rmsnorm: rows alone equal the same rows of [8, D] "
          f"and [1024, D], bit for bit, D {SERVED_WIDTHS}, f32 and bf16")


# the d_model of the trained paths: llama3.2-3b (3072), small_100m (768),
# qwen3-moe-30b-a3b (2048) and gemma3-4b (2560)
TRAIN_WIDTHS = (3072, 768, 2048, 2560)
RMSNORM_BWD_MAIN = "f32 [1024, 3072]"


def _kernels_rmsnorm_bwd(head: dict) -> None:
    """The norm's backward kernel against ``rmsnorm_bwd_ref`` at
    [1024, D] for every trained width, f32 and bf16: dx within
    ``RMSNORM_BWD_TOL``, dw within ``RMSNORM_DW_REL`` of each column's sum
    of |dy x r|; each row alone gives the same dx bit for bit as in the
    batch; two runs give the same dw bit for bit. Timed beside the plain
    version and, as a yardstick of several calls (not a port), the
    backward of ``F.rms_norm(x, (D,), 1 + w)`` through autograd."""
    import torch.nn.functional as F

    from repro_torch.kernels import ref
    from repro_torch.kernels.rmsnorm import (bwd_blocks, bwd_plan,
                                             rmsnorm_bwd_cuda)

    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    for dtype in (torch.float32, torch.bfloat16):
        for D in TRAIN_WIDTHS:
            N = 1024
            label = f"{_label(dtype)} [{N}, {D}]"
            x = torch.randn((N, D), generator=gen, device="cuda").to(dtype)
            w = (0.1 * torch.randn(D, generator=gen, device="cuda")).to(dtype)
            dy = torch.randn((N, D), generator=gen, device="cuda").to(dtype)
            dx, dw = rmsnorm_bwd_cuda(x, w, dy, 1e-5)
            want_dx, want_dw = ref.rmsnorm_bwd_ref(x, w, dy, 1e-5)
            torch.cuda.synchronize()
            err, worst = _compare("rmsnorm_bwd", label + " dx", dtype, dx,
                                  want_dx, RMSNORM_BWD_TOL[dtype])
            xf = x.float()
            r = torch.rsqrt((xf * xf).mean(-1, keepdim=True) + 1e-5)
            mag = (dy.float() * xf * r).abs().sum(0)
            dw_err = (dw - want_dw).abs()
            dw_worst = float((dw_err / (RMSNORM_DW_REL * mag + 1e-30)).max())
            check(dw.dtype == torch.float32 and dw_worst <= 1.0
                  and bool(torch.isfinite(dw).all()),
                  f"rmsnorm_bwd [{label}]: dw off by {dw_worst:.3g} times "
                  f"its limit (max {float(dw_err.max()):.3g})")
            for row in (0, 1, 517, N - 1):
                alone, _ = rmsnorm_bwd_cuda(x[row:row + 1], w,
                                            dy[row:row + 1], 1e-5)
                check(torch.equal(alone, dx[row:row + 1]),
                      f"rmsnorm_bwd [{label}]: row {row} alone differs from "
                      f"the same row in the batch")
            check(torch.equal(rmsnorm_bwd_cuda(x, w, dy, 1e-5)[1], dw),
                  f"rmsnorm_bwd [{label}]: two runs give different dw")
            ms = time_ms(lambda: rmsnorm_bwd_cuda(x, w, dy, 1e-5))
            plain = time_ms(lambda: ref.rmsnorm_bwd_ref(x, w, dy, 1e-5))
            xl = x.detach().clone().requires_grad_()
            w1 = (1.0 + w).detach().requires_grad_()
            yl = F.rms_norm(xl, (D,), weight=w1, eps=1e-5)
            lib = time_ms(lambda: torch.autograd.grad(
                yl, (xl, w1), dy, retain_graph=True))
            # x and dy read once, dx written once, w read, dw (fp32)
            # written; about 10 fp32 flops an element
            bms, by = bound_ms(3 * N * D * x.element_size()
                               + D * x.element_size() + 4 * D,
                               10.0 * N * D, torch.float32)
            p = bwd_plan(D, dtype)
            print(f"[kernels] rmsnorm_bwd {label} {tuple(p)} "
                  f"{bwd_blocks(N, p)} blocks: {ms:.4f} ms, plain "
                  f"{plain:.4f} ms, F.rms_norm backward (yardstick, several "
                  f"calls) {lib:.4f} ms ({lib / ms:.2f}x the kernel's time), "
                  f"bound {bms:.4f} ms ({by}; {bms / ms:.1%} of it), dx max "
                  f"err {err:.3g} ({worst:.2f} of the limit), dw "
                  f"{float(dw_err.max()):.3g} ({dw_worst:.2f} of the limit)")
            if label == RMSNORM_BWD_MAIN:
                head["rmsnorm_bwd"] = dict(ms=ms, plain_ms=plain,
                                           library_ms=lib, bound_ms=bms,
                                           bound_by=by, max_abs_err=err)
    print("[kernels] rmsnorm_bwd: rows alone give the batch's dx and two "
          "runs the same dw, bit for bit, at every trained width")


def _ssd_case(gen, dtype, Bt, S, nh=32, hd=64, ds=128, zero_tail=0):
    """Scan inputs at mamba2-370m's widths (or ``nh``, ``ds`` given): x, B,
    C ~ N(0, 1) in ``dtype``, as strided slices of one [Bt, S, nh hd + 2
    ds] tensor, as the mixer passes its ``xBC`` projection; dt =
    softplus(N(0, 1)), the last ``zero_tail`` tokens 0 (masked pad
    tokens); A = -linspace(1, 16) (the model's init); a random carried
    state."""
    import torch.nn.functional as F

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")
    dt = F.softplus(randn(Bt, S, nh))
    if zero_tail:
        dt[:, S - zero_tail:] = 0.0
    xBC = randn(Bt, S, nh * hd + 2 * ds).to(dtype)
    d_in = nh * hd
    return (xBC[..., :d_in].reshape(Bt, S, nh, hd), dt,
            -torch.linspace(1.0, 16.0, nh, device="cuda"),
            xBC[..., d_in:d_in + ds], xBC[..., d_in + ds:],
            randn(Bt, nh, hd, ds))


def _ssd_work(x, B, chunk):
    """Bytes (inputs read once, y and the state written once) and the
    operations of the chunked dual form over this run's rows: the
    tensor-core products of the kernel's body, with the split of each
    fp32 factor into bf16 hi + lo counted (two products per pair, three
    with f32 inputs): C.B^T over each chunk's causal pairs (once, shared
    by the heads), W.x over the same pairs, C.H_in^T and the chunk states
    x^T (B dt e^...); and, for comparison with the first version's bound,
    the same work as fp32 multiply-adds (no split)."""
    Bt, S, nh, hd = x.shape
    ds = B.shape[-1]
    nbytes = (x.numel() + 2 * B.numel()) * x.element_size() \
        + 4 * (Bt * S * nh + nh + Bt * S * nh * hd + 2 * Bt * nh * hd * ds)
    pairs = 0.0
    for t0 in range(0, S, chunk):
        n = min(chunk, S - t0)
        pairs += n * (n + 1) / 2
    split = 3 if x.dtype == torch.float32 else 2
    cb = 2 * pairs * ds * Bt
    wx = 2 * pairs * nh * hd * Bt
    inter_states = 2 * 2 * S * nh * hd * ds * Bt
    mma = (split if x.dtype == torch.float32 else 1) * cb \
        + split * (wx + inter_states)
    return nbytes, mma, cb + wx + inter_states


def _kernels_ssd_scan(head: dict) -> None:
    """Full-width prefill rows of 1024 tokens (1 and 4 rows, the chunk of
    256), one chunk (1 x 256), 2 rows of 700 tokens (a ragged last chunk,
    read in place) whose last 200 tokens have dt = 0, and jamba-v0.1's
    d_state 16 at nh 128; f32 and bf16, x, B and C strided slices of one
    projection as the mixer passes them. Then each row of the 4-row batch
    alone against its row of the batch, bit for bit, y and the state."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.ssd_scan import ssd_scan_cuda

    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    chunk = 256
    cases = [(dtype, rows, S, tail, nh, ds)
             for rows, S, tail, nh, ds in ((1, 1024, 0, 32, 128),
                                           (4, 1024, 0, 32, 128),
                                           (1, 256, 0, 32, 128),
                                           (2, 700, 200, 32, 128),
                                           (1, 1024, 0, 128, 16))
             for dtype in (torch.float32, torch.bfloat16)]
    for dtype, rows, S, tail, nh, ds in cases:
        label = f"{_label(dtype)} {rows} x {S}" \
            + (f", dt = 0 on the last {tail}" if tail else "") \
            + (f", nh {nh} d_state {ds}" if ds != 128 else "")
        args = _ssd_case(gen, dtype, rows, S, nh=nh, ds=ds, zero_tail=tail)
        y, h = ssd_scan_cuda(*args, chunk)
        y_ref, h_ref = ref.ssd_scan_ref(*args, chunk)
        torch.cuda.synchronize()
        errs = []
        for what, got, want in (("y", y, y_ref), ("state", h, h_ref)):
            scale = float(want.abs().max())
            errs.append(_compare("ssd_scan", f"{label}, {what}", dtype, got,
                                 want, dict(atol=SSD_REL * scale, rtol=0.0,
                                            cap=float("inf")))[0])
        if tail:              # a zero-dt tail leaves the state unchanged
            _, h_cut = ref.ssd_scan_ref(*(a[:, :S - tail] if a.dim() > 1
                                          and a.shape[1] == S else a
                                          for a in args), chunk)
            _compare("ssd_scan", f"{label}, state vs the cut rows", dtype, h,
                     h_cut, dict(atol=SSD_REL * float(h_cut.abs().max()),
                                 rtol=0.0, cap=float("inf")))
        if rows == 4:         # each row alone is its row of the batch
            for b in range(rows):
                ya, ha = ssd_scan_cuda(*(a[b:b + 1] if a.dim() > 1 else a
                                         for a in args), chunk)
                check(torch.equal(ya, y[b:b + 1]) and
                      torch.equal(ha, h[b:b + 1]),
                      f"ssd_scan [{label}]: row {b} alone differs from the "
                      f"same row in the batch")
            # strided slices read as their contiguous copies, bit for bit
            yc, hc = ssd_scan_cuda(*(a.contiguous() for a in args), chunk)
            check(torch.equal(yc, y) and torch.equal(hc, h),
                  f"ssd_scan [{label}]: contiguous copies differ from the "
                  f"strided slices")
            print(f"[kernels] ssd_scan {label}: each row alone equals its "
                  f"row of the batch, and contiguous copies the strided "
                  f"slices, bit for bit")
        ms = time_ms(lambda: ssd_scan_cuda(*args, chunk))
        plain = time_ms(lambda: ref.ssd_scan_ref(*args, chunk), reps=10,
                        spin_ms=60.0)
        nbytes, mma, fp32 = _ssd_work(args[0], args[3], chunk)
        bms, by = bound_ms(nbytes, mma, torch.bfloat16)
        old, old_by = bound_ms(nbytes, fp32, torch.float32)
        print(f"[kernels] ssd_scan {label}: {ms:.4f} ms, plain {plain:.4f} "
              f"ms, no library call, bound {bms:.4f} ms ({by}; "
              f"{mma / 1e9:.3g} GFLOP of bf16 MMAs, {nbytes / 1e6:.3g} MB; "
              f"the first version's fp32 bound {old:.4f} ms, {old_by}), max "
              f"err y {errs[0]:.3g} (of {float(y_ref.abs().max()):.3g}), "
              f"state {errs[1]:.3g} (of {float(h_ref.abs().max()):.3g})")
        if label == "bf16 1 x 1024":
            head["ssd_scan"] = dict(ms=ms, plain_ms=plain, library_ms=None,
                                    bound_ms=bms, bound_by=by,
                                    max_abs_err=errs[0])


def _ssd_bwd_work(x, B, chunk):
    """Bytes (the forward's inputs, dy and dh read once; dx, ddt, dA, dB,
    dC and dh0 written once) and the backward's operations over this
    run's rows, as the algorithm's multiply-adds (over each chunk's causal
    pairs, G = dy.x^T, dx's W.dy, dB's and dC's Q products per head and
    C.B^T once a chunk; per row, the chunk state, the state gradient's
    chunk term, dH_out.B, dH_out^T.x and H_in^T.dy, [hd x ds] each): as
    fp32 multiply-adds (the first version's bound), and on the tensor
    cores with each fp32 factor split into bf16 hi + lo, as ``_ssd_work``
    counts the forward (three products a pair with f32 inputs; two with
    bf16 inputs, one for C.B^T, whose factors are exact in bf16)."""
    Bt, S, nh, hd = x.shape
    ds = B.shape[-1]
    es = x.element_size()
    nbytes = 2 * (x.numel() + 2 * B.numel()) * es \
        + 4 * (2 * Bt * S * nh + 2 * nh + Bt * S * nh * hd
               + 3 * Bt * nh * hd * ds)
    pairs = 0.0
    for t0 in range(0, S, chunk):
        n = min(chunk, S - t0)
        pairs += n * (n + 1) / 2
    cb = Bt * 2 * pairs * ds
    rest = Bt * nh * (2 * pairs * (2 * hd + 2 * ds) + 2 * 5 * S * hd * ds)
    split = 3 if x.dtype == torch.float32 else 2
    mma = (split if x.dtype == torch.float32 else 1) * cb + split * rest
    return nbytes, cb + rest, mma


def _kernels_ssd_scan_bwd(head: dict) -> None:
    """The scan's backward kernels against ``ssd_scan_bwd_ref`` in f32 and
    bf16 at mamba2-370m's widths (1 and 2 rows of 1024, chunk 256),
    jamba-v0.1's (nh 128, d_state 16), small_100m's Mamba2 (8 rows of
    128, nh 24, chunk 64: the training script's shape) and 2 rows of 700
    tokens (a ragged last chunk) whose last 200 have dt = 0; x, B and C
    strided slices of one projection. Each gradient within ``SSD_REL`` of
    its largest magnitude (bf16 dx, dB and dC: plus one bf16 ulp); the
    zero-dt rows' dx 0; each row of a batch alone equal to its row (dx,
    ddt, dB, dC, dh0), bit for bit; two runs the same dA. Timed cold-L2,
    median of 20, beside its plain version; no single library call
    computes it. The bound is that of the function's products on the
    tensor cores with the fp32 factors split (``_ssd_bwd_work``), with the
    first version's fp32 bound beside it."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.ssd_scan import ssd_scan_bwd_cuda

    gen = torch.Generator(device="cuda")
    gen.manual_seed(4)
    for dtype in (torch.float32, torch.bfloat16):
        for rows, S, tail, nh, ds, chunk in ((1, 1024, 0, 32, 128, 256),
                                             (2, 1024, 0, 32, 128, 256),
                                             (1, 1024, 0, 128, 16, 256),
                                             (8, 128, 0, 24, 128, 64),
                                             (2, 700, 200, 32, 128, 256)):
            label = f"{_label(dtype)} {rows} x {S}" \
                + (f", dt = 0 on the last {tail}" if tail else "") \
                + (f", nh {nh} d_state {ds}" if ds != 128 else "") \
                + (f", nh {nh} chunk {chunk} (small_100m)" if chunk != 256
                   else "")
            args = _ssd_case(gen, dtype, rows, S, nh=nh, ds=ds,
                             zero_tail=tail)
            dy = torch.randn((rows, S, nh, 64), generator=gen, device="cuda")
            dh = torch.randn((rows, nh, 64, ds), generator=gen,
                             device="cuda")
            got = ssd_scan_bwd_cuda(*args, dy, dh, chunk)
            want = ref.ssd_scan_bwd_ref(*args, dy, dh, chunk)
            torch.cuda.synchronize()
            errs = {}
            for name, g, w in zip(SSD_BWD_NAMES, got, want):
                check(g.dtype == w.dtype and g.shape == w.shape,
                      f"ssd_scan_bwd [{label}]: {name} is {g.dtype} "
                      f"{tuple(g.shape)}, the plain version's {w.dtype} "
                      f"{tuple(w.shape)}")
                rtol = TOL[torch.bfloat16]["rtol"] \
                    if g.dtype == torch.bfloat16 else 0.0
                scale = float(w.float().abs().max())
                err, _ = _compare("ssd_scan_bwd", f"{label}, {name}", dtype,
                                  g, w, dict(atol=SSD_REL * scale + 1e-30,
                                             rtol=rtol, cap=float("inf")))
                errs[name] = (err, err / max(scale, 1e-30))
            if tail:
                check(not bool(got[0][:, S - tail:].float().any()),
                      f"ssd_scan_bwd [{label}]: the zero-dt rows got dx")
            if rows > 1:
                for b in range(rows):
                    alone = ssd_scan_bwd_cuda(
                        *(a[b:b + 1] if a.dim() > 1 else a for a in args),
                        dy[b:b + 1], dh[b:b + 1], chunk)
                    for i in (0, 1, 3, 4, 5):
                        check(torch.equal(alone[i], got[i][b:b + 1]),
                              f"ssd_scan_bwd [{label}]: row {b} alone gives "
                              f"another {SSD_BWD_NAMES[i]} than in the batch")
                check(torch.equal(ssd_scan_bwd_cuda(*args, dy, dh, chunk)[2],
                                  got[2]),
                      f"ssd_scan_bwd [{label}]: two runs give different dA")
                print(f"[kernels] ssd_scan_bwd {label}: each row alone "
                      f"gives its dx, ddt, dB, dC and dh0 of the batch, and "
                      f"two runs the same dA, bit for bit")
            ms = time_ms(lambda: ssd_scan_bwd_cuda(*args, dy, dh, chunk))
            plain = time_ms(lambda: ref.ssd_scan_bwd_ref(*args, dy, dh,
                                                         chunk),
                            reps=10, spin_ms=60.0)
            nbytes, flops, mma = _ssd_bwd_work(args[0], args[3], chunk)
            bms, by = bound_ms(nbytes, mma, torch.bfloat16)
            old, old_by = bound_ms(nbytes, flops, torch.float32)
            print(f"[kernels] ssd_scan_bwd {label}: {ms:.4f} ms, plain "
                  f"{plain:.4f} ms, no library call, bound {bms:.4f} ms "
                  f"({by}; {mma / 1e9:.3g} GFLOP of the function's bf16 "
                  f"products with the split, {nbytes / 1e6:.3g} MB; {bms / ms:.1%} of the "
                  f"time), the first version's fp32 bound {old:.4f} ms "
                  f"({old_by}; {flops / 1e9:.3g} GFLOP; {old / ms:.1%}); max "
                  f"err, and of the largest magnitude: " + ", ".join(
                      f"{n} {e:.3g} ({r:.2g})" for n, (e, r) in errs.items()))
            if label == "f32 1 x 1024":
                head["ssd_scan_bwd"] = dict(
                    ms=ms, plain_ms=plain, library_ms=None, bound_ms=bms,
                    bound_by=by, max_abs_err=max(e for e, _ in
                                                 errs.values()))


# ---------------------------------------------------------------- phase 3

def _model_config(arch: str):
    """The port's config of ``arch``: the registry's, or the paper's own
    model (``configs/paper_models``, outside the registry as in JAX)."""
    from repro_torch.configs import get_config, paper_models
    if arch == "llama3-8b":
        return paper_models.LLAMA3_8B
    if arch == "qwen-7b":
        return paper_models.QWEN_7B
    return get_config(arch)


def _replica(arch: str, scheme: str, kv_quant: bool, kv_cfg=None,
             tp: int = 1, max_len: int = 2048, backend_wrap=None):
    """A full-width replica on the card (bf16 weights, 8 slots,
    ``--max-len 2048`` unless ``max_len`` says otherwise, 64-token blocks,
    seed 0, priced on the H100 spec) as ``make_torch_replica`` builds it
    (over ``tp`` ranks, the engine wrapped in ``backend_wrap``), or, for
    int8 KV pages, from the factory's own pieces with
    ``TorchEngine(kv_quant=True)``: the factory, like the JAX one, has no
    int8 switch."""
    from repro_torch.core.kvpool import KVPool, kv_bytes_per_block
    from repro_torch.core.predictor import H100, ModelCostModel
    from repro_torch.core.scheduler import (NiyamaConfig, NiyamaScheduler,
                                            SarathiScheduler)
    from repro_torch.engine.torch_backend import TorchEngine
    from repro_torch.serving.kvcache import KVHierarchy
    from repro_torch.serving.replica import Replica
    from repro_torch.serving.schemes import make_torch_replica

    cfg = _model_config(arch)
    kw = dict(n_slots=8, max_len=max_len, block_size=64, quantum=32, seed=0)
    if not kv_quant:
        return make_torch_replica(scheme, cfg, hw=H100, device="cuda",
                                  dtype=torch.bfloat16, kv_cfg=kv_cfg,
                                  tp=tp, backend_wrap=backend_wrap, **kw)
    n, L, bs = kw["n_slots"], kw["max_len"], kw["block_size"]
    nb = n * L // bs
    kv = KVHierarchy(nb, bs, cfg=kv_cfg, bytes_per_block=kv_bytes_per_block(
        cfg, bs, bytes_per=4), max_seqs=n) if kv_cfg is not None \
        else KVPool(nb, bs, max_seqs=n)
    eng = TorchEngine(cfg, n_slots=n, max_len=L, quantum=kw["quantum"],
                      seed=kw["seed"], dtype=torch.bfloat16, pool=kv,
                      device="cuda", kv_quant=True)
    cost = ModelCostModel(cfg, H100)
    if scheme == "niyama":
        sched = NiyamaScheduler(cost, cfg=NiyamaConfig(
            max_chunk=L, quantum=kw["quantum"], fixed_chunk=64,
            max_decode_batch=n))
    else:
        sched = SarathiScheduler(cost, policy=scheme.split("-", 1)[1],
                                 chunk_size=64, max_decode_batch=n)
    return Replica(scheduler=sched, backend=eng, kv=kv)


def _long_prompt_requests(rng, n: int):
    """The serve script's mix (arrivals over ``n`` seconds, 4-23 output
    tokens, the three tiers in turn, every fifth request unimportant)
    with prompts of 1100-1899 tokens, longer than gemma3-4b's 1024-token
    window, within ``--max-len 2048``."""
    from repro_torch.core.request import Request
    from repro_torch.serving.schemes import CPU_TIERS

    reqs = []
    for i, t in enumerate(np.sort(rng.uniform(0, n * 1.0, n))):
        q = CPU_TIERS[i % 3]
        reqs.append(Request(
            rid=i, arrival=float(t), prompt_len=int(rng.integers(1100, 1900)),
            decode_len=int(rng.integers(4, 24)), qos=q, app_id=q.name,
            important=bool(i % 5)))
    return reqs


@contextlib.contextmanager
def _counts_after_warm():
    """While open, an engine's ``warm()`` zeroes the kernel counts and the
    MoE rung tally as it returns, so that a run of the serve script, which
    warms its engine before it serves, counts the launches of its
    requests and not those of the warm-up."""
    from repro_torch.engine.torch_backend import (ReferenceTorchEngine,
                                                  TorchEngine)
    from repro_torch.kernels import ops
    from repro_torch.models import moe

    saved = {cls: cls.__dict__["warm"]
             for cls in (TorchEngine, ReferenceTorchEngine)}

    def zeroing(warm):
        def wrapped(self, *a, **kw):
            n = warm(self, *a, **kw)
            ops.reset_counts()
            moe.rungs.clear()
            return n
        return wrapped

    for cls, warm in saved.items():
        cls.warm = zeroing(warm)
    try:
        yield
    finally:
        for cls, warm in saved.items():
            cls.warm = warm


def phase_serve(path: str) -> tuple:
    """Serve 12 requests on ``path`` at full width with the counts zeroed
    just before (after the engine's warm-up); returns the counts read just
    after, and the engine. The
    paths with ``script`` run the serve script (``repro_torch.launch.serve``)
    as a user does; the others serve the script's request mix through the
    replica that ``_replica`` builds (the int8 path with int8 pages, the
    paper's llama3-8b from ``paper_models``); a path with ``long_prompts``
    serves ``_long_prompt_requests`` instead; each must have launched its
    ``variants``."""
    from repro_torch.core.kvpool import kv_bytes_per_block
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models import moe
    from repro_torch.serving.metrics import compute_metrics

    p = PATHS[path]
    arch, kv_quant, kernels = p.arch, p.kv_quant, p.kernels
    ops.reset_counts()
    moe.rungs.clear()
    t0 = time.perf_counter()
    with _counts_after_warm():
        if p.script:
            rep = serve.main(["--arch", arch, "--device", "cuda", "--dtype",
                              "bf16", "--n-requests", "12", "--max-len",
                              "2048", "--slots", "8", "--seed", "0",
                              "--kv-layout", p.kv_layout])
        else:
            rep = _replica(arch, "niyama", kv_quant=kv_quant)
            rep.backend.warm()
            rng = np.random.default_rng(0)
            rep.submit_all(_long_prompt_requests(rng, 12) if p.long_prompts
                           else serve.make_requests(rng, 12, 2048))
            rep.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.counts()
    variants = ops.variants()
    rungs = dict(sorted(moe.rungs.items()))
    reads = sum(rungs.values())
    eng = rep.backend
    reqs = rep.all_requests()
    check(len(rep.finished) == len(reqs) == 12,
          f"serve {path}: {len(rep.finished)}/{len(reqs)} requests finished")
    for r in reqs:
        got = len(eng.generated[r.rid])
        check(got == r.decode_len, f"serve {path}: rid {r.rid} streamed "
              f"{got} of {r.decode_len} tokens")
        check(all(0 <= t < eng.cfg.vocab_size for t in eng.generated[r.rid]),
              f"serve {path}: rid {r.rid} sampled an id outside the "
              f"vocabulary")
    for name in kernels:
        check(counts[name]["launches"] > 0,
              f"serve {path}: {name} was never launched")
    for name, v in p.variants:
        check(variants[name].get(v, 0) > 0,
              f"serve {path}: {name} never launched as {v}: "
              f"{variants[name]}")
    for name, c in counts.items():
        check(c["plain"] == 0,
              f"serve {path}: the plain {name} ran {c['plain']} times")
        check(name in kernels or c["launches"] == 0,
              f"serve {path}: {name}, not on this path, launched "
              f"{c['launches']} times")
    n_tok = sum(len(g) for g in eng.generated.values())
    n_prompt = sum(r.prompt_len for r in reqs)
    busy = rep.busy_time      # wall time inside the engine's iterations
    m = compute_metrics(reqs, rep.now)
    print(f"[serve] {path}: {len(reqs)} requests, {rep.iterations} "
          f"iterations, "
          f"{n_prompt} prompt + {n_tok} output tokens; {wall:.2f} s wall "
          f"with the model build, {busy:.2f} s in iterations: "
          f"{n_tok / busy:.1f} output tok/s, {(n_prompt + n_tok) / busy:.1f} "
          f"tok/s; TTFT p99 {m.ttft_p99:.3f} s, TBT p99 "
          f"{m.tbt_p99 * 1e3:.1f} ms; launches {counts}")
    print(f"[serve] {path}: page-window buckets: {eng.gather_bucket_hits}; "
          f"shape buckets {len(eng.buckets_seen)}; attention launches by "
          f"variant {variants}")
    n_moe = sum(1 for l in eng.cfg.layers if l.ffn == "moe")
    check((reads > 0) == (n_moe > 0),
          f"serve {path}: {reads} host reads of the MoE segment size over "
          f"{n_moe} MoE layers")
    if n_moe:
        print(f"[serve] {path}: {reads} host reads of the largest expert "
              f"segment over {rep.iterations} iterations, "
              f"{reads / rep.iterations:.1f} an iteration: "
              f"one per MoE layer ({n_moe}) and sub-batch; capacity rungs "
              f"(rows an expert: calls) {rungs}")
    if kv_quant:
        q8 = kv_bytes_per_block(eng.cfg, eng.block_size, kv_quant=True)
        b16 = kv_bytes_per_block(eng.cfg, eng.block_size, bytes_per=2)
        print(f"[serve] {path}: kv_bytes_per_block int8 {q8} against bf16 "
              f"{b16} ({q8 / b16:.3f})")
    return counts, eng


# ---------------------------------------------------------------- phase 4

def _device_us(event) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        t = getattr(event, attr, None)
        if t:
            return float(t)
    return 0.0


# the kernels of the port, as the profiler names them
OWN_KERNELS = ("paged_decode", "chunked_prefill", "rmsnorm_kernel",
               "ssd_chunk_state_kernel", "ssd_state_pass_kernel",
               "ssd_chunk_scan_kernel")


def phase_profile(eng, prefill: bool = True, at: tuple = (1000, 0)) -> None:
    """Where one decode and (with ``prefill``) one prefill iteration of a
    served engine spend their time: host wall time per iteration, device
    busy time by kernel (torch.profiler) and the device's idle share; for
    an engine with MoE layers, also the device time of the router, the
    expert products and the combine (``_moe_split``). ``at``: the decode
    rows' context and the prefill row's start. The iterations write the
    engine's cache in place; the engine serves nothing after."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import transformer as T

    ctx, start = at
    n, dev = eng.n_slots, eng.device
    mb = -(-max(ctx + 1, start + 1024) // eng.block_size)
    i32 = dict(dtype=torch.int32, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)

    def z(*shape):
        return torch.zeros(shape, **i32)

    def tokens(*shape):
        # random ids: a MoE routes each token by its value, and one id
        # repeated would send every row to the same experts
        return torch.randint(0, eng.cfg.vocab_size, shape, generator=gen,
                             **i32)
    bt = torch.arange(n * mb, **i32).reshape(n, mb)
    def flags(*shape, value=False):
        return torch.full(shape, value, dtype=torch.bool, device=dev)
    # block tables (decode, prefill) in the paged layout; the dense one
    # reads the slots' rows
    dec_bts, pre_bts = ((z(0, mb), bt), (bt[:1], z(0, mb))) if eng.paged \
        else ((None, None), (None, None))
    pre_name = "prefill 1 row of 1024 tokens" + (f" at {start}" if start
                                                 else "")
    plans = {
        f"decode 8 rows at {ctx} tokens": (
            z(0, 1), z(0), z(0), z(0), flags(0), z(0), tokens(n),
            torch.full((n,), ctx, **i32), flags(n, value=True), *dec_bts),
        pre_name: (
            tokens(1, 1024), z(1), torch.full((1,), start, **i32),
            torch.full((1,), 1024, **i32), flags(1, value=start == 0),
            torch.full((1,), 1023, **i32), z(0), z(0), flags(0), *pre_bts),
    }
    if not prefill:
        del plans[pre_name]
    tag = (f"{eng.cfg.name}{' int8' if eng.kv_quant else ''}"
           f"{'' if eng.paged else ' dense'}")
    reps = 5
    for name, args in plans.items():
        def step():
            return T.fused_serve_forward(eng.params, eng.cfg, eng.cache,
                                         *args)
        step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) / reps * 1e3
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                step()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages() if _device_us(e) > 0]
        kernels = {e.key: _device_us(e) / reps / 1e3 for e in events}
        launches = sum(e.count for e in events) / reps
        busy = sum(kernels.values())
        if busy == 0:
            print(f"[profile] {tag} {name}: {wall_ms:.2f} ms wall "
                  f"per iteration; "
                  f"device time not measured (the profiler saw no kernel)")
            continue
        own = {o: sum(t for k, t in kernels.items() if o in k)
               for o in OWN_KERNELS}
        own_ms = sum(own.values())
        gemm = sum(t for k, t in kernels.items()
                   if any(w in k.lower() for w in ("gemm", "cutlass",
                                                   "sm90_xmma", "nvjet")))
        top = sorted(kernels.items(), key=lambda kv: -kv[1])[:5]
        own_txt = ", ".join(f"{o} {t:.2f}" for o, t in own.items() if t)
        print(f"[profile] {tag} {name}: {wall_ms:.2f} ms wall per "
              f"iteration, {launches:.0f} kernels, device busy {busy:.2f} ms "
              f"(idle share {max(0.0, 1 - busy / wall_ms):.1%}): the port's "
              f"kernels {own_ms:.2f} ms ({own_txt}), GEMMs {gemm:.2f} ms, "
              f"other {busy - own_ms - gemm:.2f} ms")
        for k, t in top:
            print(f"[profile]   {t:.3f} ms  {k[:90]}")
        if any(l.ffn == "moe" for l in eng.cfg.layers):
            attn = own["paged_decode"] + own["chunked_prefill"]
            _moe_split(f"{tag} {name}", step, reps, busy, attn,
                       own["rmsnorm_kernel"])


# the spans of ``models/moe.py`` whose device time the profile reads
MOE_SPANS = {"router": "moe.router", "expert products": "moe.experts",
             "combine": "moe.combine"}


def _moe_split(what: str, step, reps: int, busy: float, attn: float,
               norms: float) -> None:
    """Profile ``step`` again with the host's ops, and print the device
    time under each of ``MOE_SPANS`` beside attention, the norms and the
    rest of ``busy``, and the capacity rungs (rows an expert) that the
    grouped buffer took. A span that reads no device time fails."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import moe

    moe.rungs.clear()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            step()
        torch.cuda.synchronize()
    rungs = dict(sorted(moe.rungs.items()))
    # a span's device time: the kernels launched inside it, as its
    # host-side event adds them up
    spans = {label: 0.0 for label in MOE_SPANS}
    names = {v: k for k, v in MOE_SPANS.items()}
    for e in prof.key_averages():
        if e.key in names and str(e.device_type).endswith("CPU"):
            spans[names[e.key]] += getattr(e, "device_time_total",
                                           0.0) / reps / 1e3
    print(f"[profile] {what}: capacity rungs (rows an expert: calls) "
          f"{rungs}")
    check(all(spans.values()), f"profile {what}: a MoE span read no "
          f"device time: {spans}")
    rest = busy - attn - norms - sum(spans.values())
    print(f"[profile] {what}, by part: attention kernels {attn:.2f} ms, "
          f"norms {norms:.2f} ms, "
          + ", ".join(f"{k} {t:.2f} ms" for k, t in spans.items())
          + f", other ops {rest:.2f} ms (of {busy:.2f} ms busy)")


# ---------------------------------------------------------------- phase 5

def _clone_cache(cache):
    return {"layers": [type(c)(*(t.clone() for t in c))
                       for c in cache["layers"]]}


# two logits of the plain run closer than this are a near-tie: an argmax
# between them may flip on the kernels' summation order alone (f32 hidden
# states within ``parity_hidden``, times |lm_head| ~ 0.02 over d_model)
NEAR_TIE_LOGIT = 1e-4
# the grouped MoE against the dropless sweep on the card, f32: both route
# through the same ``_route``, so they can differ only where cuBLAS sums
# a row's products in another order for another row count (the grouped
# buffer holds C rows an expert, the sweep every token): a few fp32 ulps
# of outputs of magnitude ~1. The whole 2-layer iteration served with
# ``moe_impl="dropless"`` against the grouped default is held to the
# path's ``parity_hidden``: the same reordering, carried through a layer.
MOE_GROUPED_DROPLESS = 1e-5


def phase_parity(path: str) -> None:
    """Two full-width layers of ``path``'s arch in f32 (its
    ``parity_layers``; qwen3-moe-30b-a3b: 7.4 GB of weights, 4.8 GB of
    them experts; gemma3-4b: a sliding-window and a global layer, with
    positions up to 2000 past the 1024-token window), one mixed iteration
    (ragged prefill rows, a pad row, decode slots two of them inactive)
    through the kernels and through the plain versions, with pages in the
    model dtype or int8 pages: the final hidden states within the path's
    ``parity_hidden``, the written pages within 1e-4 (int8: one int8
    step, and the scales within one bf16 ulp), equal sampled ids (with
    ``near_tie``: equal or a logged near-tie, ``_ids_agree``). With MoE
    layers, then the same iteration served with ``moe_impl="dropless"``
    against the grouped default (hidden states within ``parity_hidden``,
    equal sampled ids), and each layer's grouped MoE against its dropless
    sweep on one 1024-token row of normed hidden states, within
    ``MOE_GROUPED_DROPLESS``."""
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T

    p = PATHS[path]
    arch, kv_quant = p.arch, p.kv_quant
    full = _model_config(arch)
    cfg = dataclasses.replace(full, num_layers=2, layers=tuple(
        full.layers[i] for i in p.parity_layers))
    # a sliding-window model's positions reach past its window
    windowed = any(l.mixer == "swa" for l in cfg.layers)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    params = T.init_params(cfg, gen, "cuda", torch.float32)
    rng = np.random.default_rng(1)
    bs, n_slots, maxb = 64, 8, 32 if windowed else 16
    nb = n_slots * maxb
    cache = T.init_paged_cache(cfg, n_slots, nb, bs, torch.float32, "cuda",
                               kv_quant=kv_quant)
    for c in cache["layers"]:       # stale and prefix KV in every page
        if kv_quant:
            for t in (c.k, c.v):
                t.copy_(torch.randint(-127, 128, t.shape, generator=gen,
                                      device="cuda"))
            for t in (c.k_scale, c.v_scale):
                t.copy_(0.02 * torch.rand(t.shape, generator=gen,
                                          device="cuda") + 1e-3)
        else:
            c.k.normal_(generator=gen)
            c.v.normal_(generator=gen)
    perm = rng.permutation(nb).reshape(n_slots, maxb).astype(np.int32)

    def dev(a):
        return torch.from_numpy(np.asarray(a)).cuda()
    # prefill: rows on slots 0-2 at ragged offsets, one pad row
    pre_slots = np.array([0, 1, 2, n_slots], np.int32)
    pre_reset = np.array([1, 0, 0, 0], bool)
    pre_start = np.array([0, 1200, 1700, 0] if windowed
                         else [0, 200, 513, 0], np.int32)
    pre_len = np.array([256, 256, 90, 0], np.int32)
    pre_tokens = rng.integers(0, cfg.vocab_size, (4, 256)).astype(np.int32)
    pre_bt = np.full((4, maxb), -1, np.int32)
    pre_bt[:3] = perm[:3]
    pre_sample = np.maximum(pre_len - 1, 0).astype(np.int32)
    # decode: slots 3-7, two of them inactive (slot 6 mid-prefill length)
    dec_start = np.array([0, 0, 0, 1700, 31, 2000, 450, 1100] if windowed
                         else [0, 0, 0, 700, 31, 1000, 450, 64], np.int32)
    dec_active = np.array([0, 0, 0, 1, 1, 1, 0, 1], bool)
    dec_bt = np.full((n_slots, maxb), -1, np.int32)
    dec_bt[dec_active] = perm[dec_active]
    dec_tokens = rng.integers(0, cfg.vocab_size, n_slots).astype(np.int32)
    args = [dev(a) for a in (pre_tokens, pre_slots, pre_start, pre_len,
                             pre_reset, pre_sample, dec_tokens, dec_start,
                             dec_active, pre_bt, dec_bt)]

    def run():
        with torch.inference_mode():
            hid = T._sampled_hidden(params, cfg, _clone_cache(cache), *args)
        c = _clone_cache(cache)
        ids = T.fused_serve_forward(params, cfg, c, *args)
        return hid, ids, c

    label = "int8 pages" if kv_quant else "f32 pages"
    decode = "paged_attention_int8" if kv_quant else "paged_attention"
    # two runs; a sliding-window layer's decode rows go to the prefill
    # kernel as one-token chunks
    n_full = sum(l.mixer == "attn" for l in cfg.layers)
    want_launches = {decode: 2 * n_full, "chunked_prefill_attention":
                     2 * (2 * cfg.num_layers - n_full)}
    ops.reset_counts()
    hk, ik, ck = run()
    launched = ops.counts()
    with ops.plain_versions():
        hp, ip, cp = run()
    torch.cuda.synchronize()
    check(all(launched[k]["launches"] == n and launched[k]["plain"] == 0
              for k, n in want_launches.items()),
          f"parity {label}: the kernel path ran {launched}, not "
          f"{want_launches}")
    live = np.r_[pre_len > 0, dec_active]
    err = float((hk - hp).abs().max())
    limit = p.parity_hidden
    check(bool(torch.isfinite(hk).all()),
          f"parity {label}: non-finite hidden state")
    check(err <= limit, f"parity {label}: max |hidden kernel - plain| = "
          f"{err:.3g} > {limit}")
    if p.near_tie:
        _ids_agree(f"parity {arch} {label}", params, cfg, live, ik, ip, hk,
                   hp)
    else:
        check(torch.equal(ik[dev(live)], ip[dev(live)]),
              f"parity {label}: sampled ids differ: {ik.tolist()} vs "
              f"{ip.tolist()}")
    # every page but the sink, whose content is whichever invalid write
    # landed last
    pairs = [(x[:-1], y[:-1]) for a, b in zip(ck["layers"], cp["layers"])
             for x, y in zip(a, b)]
    if kv_quant:
        steps = [(x.int() - y.int()).abs() for x, y in pairs[0::4]
                 + pairs[1::4]]
        page_err = max(int(d.max()) for d in steps)
        moved = sum(int((d > 0).sum()) for d in steps)
        total = sum(d.numel() for d in steps)
        check(page_err <= 1, f"parity {label}: written int8 pages differ "
              f"by {page_err} steps")
        for x, y in pairs[2::4] + pairs[3::4]:
            x, y = x.float(), y.float()
            ulp = torch.exp2(torch.floor(torch.log2(
                torch.maximum(x.abs(), y.abs()).clamp_min(1e-30))) - 7)
            check(bool(((x - y).abs() <= ulp).all()),
                  f"parity {label}: written scales differ by more than one "
                  f"bf16 ulp")
        page_txt = (f"pages within {page_err} int8 step ({moved} of "
                    f"{total} values moved), scales within one bf16 ulp")
    else:
        page_err = max(float((x - y).abs().max()) for x, y in pairs)
        check(page_err <= 1e-4, f"parity {label}: written pages differ by "
              f"{page_err}")
        page_txt = f"pages {page_err:.3g}"
    print(f"[parity] {arch}, 2-layer full-width f32, {label}: max "
          f"|hidden kernel - plain| {err:.3g}, {page_txt}, sampled ids "
          f"{ik[dev(live)].tolist()} (plain {ip[dev(live)].tolist()})")
    if cfg.moe is not None:
        del hp, ck, cp
        with torch.inference_mode():
            hd = T._sampled_hidden(params, cfg, _clone_cache(cache), *args,
                                   moe_impl="dropless")
        idd = T.fused_serve_forward(params, cfg, cache, *args,
                                    moe_impl="dropless")
        torch.cuda.synchronize()
        err = float((hd - hk).abs().max())
        check(err <= limit, f"parity {label}: max |hidden dropless - "
              f"grouped| = {err:.3g} > {limit}")
        check(torch.equal(idd[dev(live)], ik[dev(live)]),
              f"parity {label}: dropless sampled {idd.tolist()}, grouped "
              f"{ik.tolist()}")
        print(f"[parity] {arch}, the same iteration with "
              f"moe_impl=\"dropless\": max |hidden dropless - grouped| "
              f"{err:.3g}, sampled ids equal")
        del hk, hd, cache
        _grouped_against_dropless(params, cfg, gen)


def _ids_agree(what, params, cfg, live, ik, ip, hk, hp) -> None:
    """Fails unless the kernels' and the plain versions' sampled ids are
    equal on the live rows, or a differing row is a near-tie: its two
    ids' logits from the plain run's hidden state within
    ``NEAR_TIE_LOGIT``, which is logged."""
    w = params.lm_head if params.lm_head is not None else params.embed.T
    for r in np.flatnonzero(live):
        a, b = int(ik[r]), int(ip[r])
        if a == b:
            continue
        with torch.inference_mode():
            lg = (hp[r] @ w)[:cfg.vocab_size]
            top = torch.topk(lg, 2)
        gap = abs(float(lg[a] - lg[b]))
        print(f"[parity] {what}: row {r} sampled {a} with the kernels, "
              f"{b} with the plain versions; their logits differ by "
              f"{gap:.3g} (top-2 {top.indices.tolist()} at "
              f"{[round(v, 6) for v in top.values.tolist()]}, kernels' "
              f"hidden state {float((hk[r] - hp[r]).abs().max()):.3g} "
              f"away)")
        check(gap <= NEAR_TIE_LOGIT, f"{what}: sampled ids differ at row "
              f"{r} ({a} vs {b}) and it is not a near-tie ({gap:.3g} > "
              f"{NEAR_TIE_LOGIT})")


def _grouped_against_dropless(params, cfg, gen) -> None:
    """Each MoE layer's grouped FFN against its dropless sweep on one
    1024-token row of normed hidden states, and the capacity rung (rows
    an expert) that the grouped buffer took."""
    from repro_torch.models import moe
    from repro_torch.models import transformer as T

    x = torch.randn((1, 1024, cfg.d_model), generator=gen, device="cuda")
    errs = []
    with torch.inference_mode():
        for li, layer in enumerate(params.layers):
            h = T.rmsnorm(x, layer.norm2, cfg.norm_eps)
            moe.rungs.clear()
            g = moe.moe_forward_grouped(layer.moe, h, cfg)
            (rung,) = moe.rungs
            d = moe.moe_forward_dropless(layer.moe, h, cfg)
            torch.cuda.synchronize()
            e = float((g - d).abs().max())
            check(bool(torch.isfinite(g).all()) and e <= MOE_GROUPED_DROPLESS,
                  f"parity {cfg.name} layer {li}: max |grouped - dropless| "
                  f"= {e:.3g} > {MOE_GROUPED_DROPLESS}")
            errs.append((e, float(d.abs().max()), rung))
    print(f"[parity] {cfg.name} grouped vs dropless MoE, 1 x 1024 tokens, "
          f"f32: max |diff| per layer "
          + ", ".join(f"{e:.3g} (of {m:.3g}; grouped at rung {c} rows an "
                      f"expert, the sweep at 1024)" for e, m, c in errs))


def phase_parity_mamba() -> None:
    """Two full-width mamba2-370m layers in f32, one mixed iteration:
    a first chunk (state reset) of 512 tokens, a chunk resuming a slot's
    state, a short first chunk, a pad row; 8 decode slots, 2 inactive.
    Kernels (rmsnorm, ssd_scan) against the plain versions."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T

    full = get_config("mamba2-370m")
    cfg = dataclasses.replace(full, num_layers=2, layers=full.layers[:2])
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    params = T.init_params(cfg, gen, "cuda", torch.float32)
    rng = np.random.default_rng(2)
    n_slots = 8
    cache = T.init_paged_cache(cfg, n_slots, 0, 64, torch.float32, "cuda")
    for c in cache["layers"]:       # every slot carries a state
        c.conv.normal_(generator=gen)
        c.ssm.normal_(generator=gen)

    def dev(a):
        return torch.from_numpy(np.asarray(a)).cuda()
    pre_slots = np.array([0, 1, 2, n_slots], np.int32)
    pre_start = np.array([0, 256, 0, 0], np.int32)
    pre_len = np.array([512, 300, 77, 0], np.int32)
    pre_reset = np.array([1, 0, 1, 0], bool)
    pre_tokens = rng.integers(0, cfg.vocab_size, (4, 512)).astype(np.int32)
    pre_sample = np.maximum(pre_len - 1, 0).astype(np.int32)
    dec_tokens = rng.integers(0, cfg.vocab_size, n_slots).astype(np.int32)
    dec_start = np.array([0, 0, 0, 700, 31, 1000, 450, 64], np.int32)
    dec_active = np.array([0, 0, 0, 1, 1, 1, 0, 1], bool)
    args = [dev(a) for a in (pre_tokens, pre_slots, pre_start, pre_len,
                             pre_reset, pre_sample, dec_tokens, dec_start,
                             dec_active, np.full((4, 1), -1, np.int32),
                             np.full((n_slots, 1), -1, np.int32))]

    def run():
        with torch.inference_mode():
            hid = T._sampled_hidden(params, cfg, _clone_cache(cache), *args)
        c = _clone_cache(cache)
        ids = T.fused_serve_forward(params, cfg, c, *args)
        return hid, ids, c

    ops.reset_counts()
    hk, ik, ck = run()
    launched = ops.counts()
    with ops.plain_versions():
        hp, ip, cp = run()
    torch.cuda.synchronize()
    check(launched["ssd_scan"]["launches"] == 2 * cfg.num_layers
          and launched["ssd_scan"]["plain"] == 0,
          f"parity mamba2: the kernel path ran {launched}")
    live = np.r_[pre_len > 0, dec_active]
    err = float((hk - hp).abs().max())
    check(bool(torch.isfinite(hk).all()),
          "parity mamba2: non-finite hidden state")
    check(err <= MAMBA_PARITY_HIDDEN,
          f"parity mamba2: max |hidden kernel - plain| = {err:.3g} > "
          f"{MAMBA_PARITY_HIDDEN}")
    check(torch.equal(ik[dev(live)], ip[dev(live)]),
          f"parity mamba2: sampled ids differ: {ik.tolist()} vs "
          f"{ip.tolist()}")
    # every slot's row (not the sink): conv windows and fp32 states
    state_err = 0.0
    for a, b in zip(ck["layers"], cp["layers"]):
        for x, y in ((a.conv, b.conv), (a.ssm, b.ssm)):
            scale = float(y[:-1].abs().max())
            e = float((x[:-1] - y[:-1]).abs().max())
            check(e <= SSD_REL * scale, f"parity mamba2: state rows differ "
                  f"by {e:.3g} (of {scale:.3g})")
            state_err = max(state_err, e / scale)
    print(f"[parity] mamba2-370m, 2-layer full-width f32: max |hidden "
          f"kernel - plain| {err:.3g}, state rows {state_err:.3g} of their "
          f"scale, sampled ids equal ({ik[dev(live)].tolist()})")


# ---------------------------------------------------------------- phase 6

# two bf16 logits closer than this many bf16 ulps of their magnitude are
# a near-tie: an argmax between them may flip on rounding alone
NEAR_TIE_ULPS = 2


def _top2(eng, tokens, chunks=None) -> tuple:
    """The engine's logits after ``tokens`` through a scratch cache of
    the engine's kind (one slot): the top two ids and logits. By default
    the whole history is one prefill row; with ``chunks`` (the prompt's
    chunk lengths, as the engine served them) the prompt runs as those
    prefill rows and the rest of ``tokens`` as decode rows, one at a
    time: a vision stub zeroes each chunk's leading positions, so its
    logits depend on where the chunks began."""
    from repro_torch.models import transformer as T

    cfg, dev, bs = eng.cfg, eng.device, eng.block_size
    n = len(tokens)
    nb = -(-n // bs)
    dtype = eng.params.embed.dtype
    cache = T.init_paged_cache(cfg, 1, nb, bs, dtype, dev,
                               kv_quant=eng.kv_quant)
    i32 = dict(dtype=torch.int32, device=dev)

    def z(*shape):
        return torch.zeros(shape, **i32)

    def one(v):
        return torch.tensor([v], **i32)
    yes = torch.ones((1,), dtype=torch.bool, device=dev)
    no = torch.zeros((0,), dtype=torch.bool, device=dev)
    bt = torch.arange(nb, **i32)[None]
    start = 0
    with torch.inference_mode():
        for c in (chunks or [n]):
            hid = T._sampled_hidden(
                eng.params, cfg, cache,
                torch.tensor([list(tokens[start:start + c])], **i32), z(1),
                one(start), one(c), yes if start == 0 else ~yes,
                one(c - 1), z(0), z(0), no, bt, z(0, nb))
            start += c
        for t in tokens[start:]:
            hid = T._sampled_hidden(
                eng.params, cfg, cache, z(0, 1), z(0), z(0), z(0), no, z(0),
                one(t), one(start), yes, z(0, nb), bt)
            start += 1
        w = eng.params.lm_head if eng.params.lm_head is not None \
            else eng.params.embed.T
        logits = (hid @ w)[0, :cfg.vocab_size].float()
    top = torch.topk(logits, 2)
    return top.indices.tolist(), top.values.tolist(), logits


def _streams_agree(what: str, eng, got: dict, want: dict,
                   chunks=None, near_tie: bool = True) -> int:
    """Fails unless the two runs streamed the same tokens for every
    request; at a first divergence it logs the top-2 logit gap there (a
    fresh forward over the shared history, ``_top2``, with the prompt's
    chunks where ``chunks`` gives them by rid) and lets it pass only as a
    near-tie between the two streams' tokens, and only with
    ``near_tie``. Returns the requests that diverged at a near-tie."""
    check(got.keys() == want.keys(), f"{what}: rids {sorted(got)} vs "
          f"{sorted(want)}")
    ties = 0
    for rid in sorted(want):
        a, b = got[rid], want[rid]
        if a == b:
            continue
        check(near_tie, f"{what}: rid {rid} diverged ({a} against {b}) "
              f"where no near-tie may pass")
        check(len(a) == len(b), f"{what}: rid {rid} streamed {len(a)} "
              f"tokens against {len(b)}")
        i = next(j for j in range(len(a)) if a[j] != b[j])
        hist = list(eng.tokens[rid]) + list(b[:i])
        ids, vals, logits = _top2(eng, hist,
                                  None if chunks is None else chunks[rid])
        la, lb = float(logits[a[i]]), float(logits[b[i]])
        ulp = 2.0 ** (np.floor(np.log2(max(abs(la), abs(lb), 1e-30))) - 7)
        print(f"[streams] {what}: rid {rid} diverges at token {i}: "
              f"{a[i]} vs {b[i]}, their logits {la:.5f} / {lb:.5f} "
              f"(top-2 {ids} at {vals[0]:.5f} / {vals[1]:.5f}, gap "
              f"{vals[0] - vals[1]:.5f})")
        check(abs(la - lb) <= NEAR_TIE_ULPS * ulp,
              f"{what}: rid {rid} diverged at token {i} and it is not a "
              f"near-tie (|{la:.5f} - {lb:.5f}| > {NEAR_TIE_ULPS} bf16 "
              f"ulps)")
        ties += 1
    return ties


def _prefix_requests():
    """Four requests sharing a 1024-token prefix, prompts of 1100-1199
    tokens, 8 output tokens, arriving 3 s apart in virtual time (each
    finishes before the next arrives, so every later one finds the
    prefix published)."""
    from repro_torch.core.request import Request
    from repro_torch.serving.schemes import CPU_TIERS
    return [Request(rid=i, arrival=3.0 * i, prompt_len=1100 + 33 * i,
                    decode_len=8, qos=CPU_TIERS[0], app_id="Q1",
                    prefix_id=7, prefix_len=1024) for i in range(4)]


def phase_hierarchy(kv_quant: bool) -> None:
    """The KV hierarchy at full width, with bf16 or int8 pages. (a) The
    prefix tier: four requests sharing a 1024-token prefix, served with
    ``KVCacheConfig(enable_prefix=True)`` and without a hierarchy, by
    Sarathi's fixed 64-token chunks (so both runs chunk every prompt's
    tail alike and do the same arithmetic for each token): the streams
    must be equal and the hot run must dispatch fewer prefill tokens.
    (b) The swap tier: a mid-decode swap-out and swap-in round trip with
    another request churning the freed blocks (tests/
    test_fused_engine.py:121-165) must stream what an uninterrupted run
    of the same engine streams."""
    from repro_torch.configs import get_config
    from repro_torch.core.kvpool import kv_bytes_per_block
    from repro_torch.core.request import Request
    from repro_torch.core.scheduler import BatchPlan
    from repro_torch.engine.torch_backend import TorchEngine
    from repro_torch.kernels import ops
    from repro_torch.serving.kvcache import KVCacheConfig, KVHierarchy
    from repro_torch.serving.schemes import CPU_TIERS

    label = "int8" if kv_quant else "bf16"
    decode = "paged_attention_int8" if kv_quant else "paged_attention"
    other = "paged_attention" if kv_quant else "paged_attention_int8"
    t0 = time.perf_counter()
    ops.reset_counts()
    runs = {}
    for name, kv_cfg in (("hot", KVCacheConfig(enable_prefix=True)),
                         ("cold", None)):
        rep = _replica("llama3.2-3b", "sarathi-fcfs", kv_quant, kv_cfg)
        rep.submit_all(_prefix_requests())
        rep.run()
        check(len(rep.finished) == 4, f"hierarchy {label} {name}: "
              f"{len(rep.finished)}/4 requests finished")
        eng = rep.backend
        runs[name] = (dict(eng.generated), eng.prefill_tokens, rep.kv)
        if name == "hot":
            kv = rep.kv
            check(kv.prefix.hit_tokens == 3 * 1024,
                  f"hierarchy {label}: prefix hits {kv.prefix.hit_tokens} "
                  f"tokens, not 3 x 1024")
            check(kv.used == kv.prefix.n_pinned == 0,
                  f"hierarchy {label}: {kv.used} blocks used, "
                  f"{kv.prefix.n_pinned} pinned after every request ended")
            hot_eng = eng
        else:
            del eng
        del rep
    _streams_agree(f"prefix {label}", hot_eng, runs["hot"][0],
                   runs["cold"][0])
    hot_tok, cold_tok = runs["hot"][1], runs["cold"][1]
    check(hot_tok < cold_tok, f"hierarchy {label}: the hot run dispatched "
          f"{hot_tok} prefill tokens, the cold one {cold_tok}")
    counts = ops.counts()
    check(counts[decode]["launches"] > 0 and counts[other]["launches"] == 0
          and all(c["plain"] == 0 for c in counts.values()),
          f"hierarchy {label}: launches {counts}")
    print(f"[hierarchy] prefix {label}: streams equal over 4 requests, "
          f"prefill tokens dispatched hot {hot_tok} / cold {cold_tok}, "
          f"{runs['hot'][2].prefix.hit_tokens} prefix tokens hit")
    del hot_eng, runs
    _free_device_memory()

    # (b) the swap tier, on one engine's plans
    cfg, bs = get_config("llama3.2-3b"), 64
    qos = CPU_TIERS[0]

    def engine(pool=None):
        return TorchEngine(cfg, n_slots=2, max_len=2048,
                           quantum=32, seed=0, dtype=torch.bfloat16,
                           block_size=bs, pool=pool, device="cuda",
                           kv_quant=kv_quant)

    def request(rid, prompt, n):
        return Request(rid=rid, arrival=0.0, prompt_len=prompt,
                       decode_len=n, qos=qos)
    base = engine()
    r = request(0, 1000, 6)
    base.on_admit(r)
    base.execute(BatchPlan(prefill=[(r, 1000)]), 0.0)
    r.prefilled = 1000
    for _ in range(5):
        base.execute(BatchPlan(decode=[r]), 0.0)
    want = {0: list(base.generated[0])}
    del base
    _free_device_memory()
    kv = KVHierarchy(64, bs, cfg=KVCacheConfig(enable_swap=True),
                     bytes_per_block=kv_bytes_per_block(
                         cfg, bs, kv_quant=kv_quant),
                     max_seqs=2)
    eng = engine(kv)
    r = request(0, 1000, 6)
    eng.on_admit(r)
    eng.execute(BatchPlan(prefill=[(r, 1000)]), 0.0)
    r.prefilled = 1000
    for _ in range(2):
        eng.execute(BatchPlan(decode=[r]), 0.0)
    held = set(kv.block_table(0))
    check(kv.on_relegate(0, 1002) == 1002 and kv.swapped_tokens(0) == 1002,
          f"hierarchy {label}: the relegation did not keep 1002 tokens")
    eng.on_release(r)
    churn = request(9, 700, 2)
    eng.on_admit(churn)
    kv.grow(9, 700)
    reused = len(set(kv.block_table(9)) & held)
    check(reused > 0, f"hierarchy {label}: the churning request got none "
          f"of the freed blocks")
    eng.execute(BatchPlan(prefill=[(churn, 700)]), 0.0)
    churn.prefilled = 700
    eng.execute(BatchPlan(decode=[churn]), 0.0)
    eng.on_release(churn)
    kv.release(9)
    for _ in range(3):
        eng.execute(BatchPlan(decode=[r]), 0.0)     # swap-resume
    torch.cuda.synchronize()
    _streams_agree(f"swap {label}", eng, {0: eng.generated[0]}, want)
    print(f"[hierarchy] swap {label}: a mid-decode round trip ({len(held)} "
          f"blocks out, {reused} of them overwritten by another request) "
          f"streams the uninterrupted run's {want[0]}; "
          f"{time.perf_counter() - t0:.1f} s for the phase")
    del eng
    _free_device_memory()


# ---------------------------------------------------------------- phase 7

def phase_reclaim() -> None:
    """SWA page reclamation at full width: llama3.2-3b's ``long_500k``
    variant (every layer sliding, window 8192) in bf16, 2 slots of 9216
    tokens. A 9000-token prompt (five chunks of up to 2048) sheds its
    dead leading blocks in the prefill bookkeeping, its decode sheds one
    more, and a second request admitted after the reclaims is granted a
    freed page id; both streams must equal, token for token, those of
    the same engine with reclamation switched off after construction.
    Every attention read goes through the prefill kernel (decode rows as
    one-token chunks), none through the decode kernel."""
    from repro_torch.configs import get_config
    from repro_torch.core.request import Request
    from repro_torch.core.scheduler import BatchPlan
    from repro_torch.engine.torch_backend import TorchEngine
    from repro_torch.kernels import ops
    from repro_torch.serving.schemes import CPU_TIERS

    cfg = get_config("llama3.2-3b", "long_500k")
    W, prompt, chunk = 8192, 9000, 2048

    def drive(reclaim: bool) -> tuple:
        eng = TorchEngine(cfg, n_slots=2, max_len=9216, quantum=32, seed=0,
                          dtype=torch.bfloat16, block_size=64,
                          device="cuda")
        check(eng._swa_reclaim_window == W, f"reclaim: the gate gives "
              f"{eng._swa_reclaim_window}, not {W}")
        if not reclaim:
            eng._swa_reclaim_window = None
        r0 = Request(rid=0, arrival=0.0, prompt_len=prompt, decode_len=33,
                     qos=CPU_TIERS[0])
        eng.on_admit(r0)
        granted = set()             # every page id rid 0 has held

        def step(plan):
            eng.execute(plan, 0.0)
            granted.update(eng.pool.block_table(0))
        for start in range(0, prompt, chunk):
            n = min(chunk, prompt - start)
            step(BatchPlan(prefill=[(r0, n)]))
            r0.prefilled = start + n
        after_prefill = eng.kv_blocks_reclaimed
        for _ in range(24):
            step(BatchPlan(decode=[r0]))
        # reclaimed and not granted again (the pool reuses the last freed
        # id first)
        freed = granted - set(eng.pool.block_table(0))
        r1 = Request(rid=1, arrival=0.0, prompt_len=500, decode_len=8,
                     qos=CPU_TIERS[0])
        eng.on_admit(r1)
        eng.execute(BatchPlan(prefill=[(r1, 500)], decode=[r0]), 0.0)
        r1.prefilled = 500
        reused = set(eng.pool.block_table(1)) & freed
        holes = sum(1 for i in eng.pool.block_table(0) if i < 0)
        for _ in range(7):
            eng.execute(BatchPlan(decode=[r0, r1]), 0.0)
        torch.cuda.synchronize()
        out = (dict(eng.generated), after_prefill, eng.kv_blocks_reclaimed,
               reused, holes)
        del eng
        _free_device_memory()
        return out

    ops.reset_counts()
    got, after_prefill, reclaimed, reused, holes = drive(True)
    counts, variants = ops.counts(), ops.variants()
    want, _, none, _, no_holes = drive(False)
    check(after_prefill > 0 and reclaimed > after_prefill,
          f"reclaim: {after_prefill} blocks reclaimed by the prefill, "
          f"{reclaimed} in all: the prefill and the decode must each shed")
    check(none == 0 and no_holes == 0, f"reclaim: the engine with the "
          f"gate off reclaimed {none} blocks, {no_holes} holes")
    check(len(reused) > 0, "reclaim: the request admitted after the "
          "reclaim holds none of the freed page ids")
    check(got == want, f"reclaim: the streams differ from the run without "
          f"reclamation: {got} vs {want}")
    check(counts["paged_attention"]["launches"] == 0
          and counts["chunked_prefill_attention"]["launches"] > 0
          and all(c["plain"] == 0 for c in counts.values())
          and set(variants["chunked_prefill_attention"])
          == {(cfg.head_dim, W)},
          f"reclaim: launches {counts}, variants {variants}")
    print(f"[reclaim] llama3.2-3b long_500k (window {W}), bf16: "
          f"{after_prefill} blocks reclaimed by the {prompt}-token "
          f"prefill, {reclaimed} in all ({holes} -1 holes in rid 0's "
          f"table); the request admitted after holds {len(reused)} freed "
          f"page ids; streams equal the run without reclamation "
          f"({len(got[0])} + {len(got[1])} tokens); prefill-kernel "
          f"launches {variants['chunked_prefill_attention']}")


# ---------------------------------------------------------------- phase 8

class _FixedClock:
    """A backend shim that reports a constant iteration time (0.05 s), as
    the CPU tests' does (tests/test_torch_engine.py): the schedulers then
    decide on virtual time alone, so a fleet and a single replica plan the
    same way on every run. Records each plan: ((rid, chunk), ...),
    (decode rids)."""

    def __init__(self, inner):
        self.inner = inner
        self.plans = []

    def execute(self, plan, now):
        self.plans.append((tuple((r.rid, c) for r, c in plan.prefill),
                           tuple(r.rid for r in plan.decode)))
        self.inner.execute(plan, now)
        return 0.05

    def __getattr__(self, name):
        return getattr(self.inner, name)


# each fleet engine: 4 slots of 2048 tokens in 64-token pages, seed 0
FLEET_KW = dict(n_slots=4, max_len=2048, block_size=64, seed=0)


def _fleet_counts(what: str) -> dict:
    """The kernel counts since the last ``ops.reset_counts()``; fails if a
    plain version ran, if a kernel off the path launched, or if a kernel
    of the path never launched."""
    from repro_torch.kernels import ops
    counts = ops.counts()
    for name, c in counts.items():
        check(c["plain"] == 0,
              f"fleet {what}: the plain {name} ran {c['plain']} times")
        check(name in ATTENTION_PATH or c["launches"] == 0,
              f"fleet {what}: {name}, not on this path, launched "
              f"{c['launches']} times")
        check(name not in ATTENTION_PATH or c["launches"] > 0,
              f"fleet {what}: {name} was never launched")
    return counts


def _fleet_requests():
    """The deterministic part's requests: five arriving together, prompts
    of 200-800 tokens; rid 0 decodes 40 tokens (the live move's subject),
    the others 8; and rid 100, a 1500-token prompt that the offload
    transfer relegates after 1024 prefilled tokens."""
    from repro_torch.core.request import Request
    from repro_torch.serving.schemes import CPU_TIERS
    reqs = [Request(rid=i, arrival=0.0, prompt_len=200 + 150 * i,
                    decode_len=40 if i == 0 else 8, qos=CPU_TIERS[0],
                    app_id="Q1") for i in range(5)]
    return reqs, Request(rid=100, arrival=0.0, prompt_len=1500,
                         decode_len=8, qos=CPU_TIERS[0], app_id="Q1")


def _warm(engines) -> None:
    """Build the kernels and run one iteration of each engine on this
    thread, before the workers start. (A helper, so that no loop variable
    of the caller keeps an engine alive past its ``del``: an engine and
    its pool form a cycle, freed only by the collector.)"""
    for eng in engines:
        eng.warm()
    torch.cuda.synchronize()


def _served_both_kinds(what: str, engines) -> None:
    """Fails unless every engine served prefill rows and decode rows (each
    plan on the card launches the kernels of its rows, or raises)."""
    for eng in engines:
        buckets = eng.buckets_seen
        check(any(P > 0 for P, _, _, _ in buckets)
              and any(nd > 0 for _, _, nd, _ in buckets),
              f"fleet {what}: an engine served buckets {buckets}")


def _streams_of(engines) -> dict:
    """Every engine's streams, rid -> tokens; fails if a rid streamed on
    two engines (a moved request's stream travels with its payload)."""
    got = {}
    for eng in engines:
        for rid, toks in eng.generated.items():
            check(rid not in got, f"fleet: rid {rid} streamed twice")
            got[rid] = list(toks)
    return got


def _fleet_deterministic(cfg) -> dict:
    """Two engines under a virtual clock with the fixed-clock shim: one
    live move of decoding rid 0 to the other engine and one
    relegation-offload transfer mid-prefill (rid 100), then the same
    requests through one ``make_torch_replica``; every stream must agree
    (``_streams_agree``). Returns the summary and the fleet run's kernel
    counts (zeroed after the warm-up, read before the reference runs)."""
    from repro_torch.core.predictor import H100
    from repro_torch.core.request import Phase
    from repro_torch.core.scheduler import BatchPlan
    from repro_torch.kernels import ops
    from repro_torch.serving.asyncfleet import VirtualClock
    from repro_torch.serving.asyncfleet.transfer import payload_nbytes
    from repro_torch.serving.schemes import (make_async_torch_fleet,
                                             make_torch_replica)

    fleet = make_async_torch_fleet(cfg, 2, dtype=torch.bfloat16, hw=H100,
                                   backend_wrap=_FixedClock,
                                   clock=VirtualClock(), **FLEET_KW)
    engines = [fleet.engine_of(rep) for rep in fleet.replicas]
    _warm(engines)
    reqs, off = _fleet_requests()
    ops.reset_counts()
    fleet.submit(reqs)
    moved, src, t = False, None, 0.0
    # step the barriers until rid 0 decodes with a few tokens out, then
    # move it (refused while the destination lacks room: step on)
    while not moved and reqs[0].phase is not Phase.FINISHED and t < 60.0:
        t += fleet.tick
        fleet.run(until=t)
        src = next((i for i, rep in enumerate(fleet.replicas)
                    if any(r.rid == 0 and r.decoded >= 3
                           for r in rep.decode_queue)), None)
        if src is not None:
            snaps = [fleet._snapshot(i) for i in range(2)]
            moved = fleet._force_live_move(0, 1 - src, fleet._t, snaps)
    check(moved, f"fleet: the live move of rid 0 never landed (t {t:.2f})")
    at_move = reqs[0].decoded
    live_bytes = fleet.report.kv_moved_bytes
    fleet.run(until=t + 120.0)
    check(all(r.phase is Phase.FINISHED for r in reqs),
          f"fleet: {[r.phase.name for r in reqs]} after the live move")
    check(any(e.kind == "live" and e.rid == 0
              for e in fleet.report.events),
          f"fleet: no live move of rid 0 in {fleet.report.events}")

    # the offload transfer: rid 100 relegated mid-prefill on replica 0
    # (its 1024 prefilled tokens parked in the engine's swap store) lands
    # on replica 1's engine through the runtime's hooks and resumes there
    srep, drep = fleet.replicas
    se = engines[0]
    off.arrival = srep.now
    srep.kv.attach(off)
    se.on_admit(off)
    se.execute(BatchPlan(prefill=[(off, 1024)]), srep.now)
    off.prefilled = 1024
    off.phase = Phase.RELEGATED
    off.was_relegated = True
    off.relegated_at = srep.now
    off.prefilled = srep.kv.on_relegate(off.rid, 1024)
    srep.relegated_queue.append(off)
    se.on_release(off)
    srep.state_version += 1
    check(off.prefilled == 1024 and fleet._transfer_ok(srep, drep, off),
          f"fleet: the offload transfer is refused (prefilled "
          f"{off.prefilled})")
    tokens = fleet._detach_swapped(srep, off)
    check(tokens == 1024 and off.rid not in se._swap_store,
          f"fleet: the offload detach gave {tokens} tokens")
    off_bytes = payload_nbytes(fleet._wire[off.rid])
    off.phase = Phase.QUEUED
    check(fleet._receive_swapped(drep, off, drep.now, tokens)
          and off.prefilled == 1024,
          "fleet: the offload payload did not land with its 1024 tokens")
    drep.run(until=drep.now + 120.0)
    check(off.phase is Phase.FINISHED and
          len(engines[1].generated[off.rid]) == off.decode_len,
          "fleet: the offloaded request did not finish on replica 1")
    torch.cuda.synchronize()
    counts = _fleet_counts("deterministic")
    _served_both_kinds("deterministic", engines)
    got = _streams_of(engines)
    plans = [len(e.plans) for e in engines]
    fleet.close()
    del fleet, engines, se, srep, drep
    _free_device_memory()

    one = make_torch_replica("niyama", cfg, dtype=torch.bfloat16, hw=H100,
                             device="cuda", backend_wrap=_FixedClock,
                             **FLEET_KW)
    reqs, off = _fleet_requests()
    ops.reset_counts()
    one.submit_all(reqs + [off])
    one.run()
    torch.cuda.synchronize()
    _fleet_counts("deterministic reference")
    check(len(one.finished) == 6, f"fleet: the single replica finished "
          f"{len(one.finished)}/6")
    want = {rid: list(t) for rid, t in one.backend.generated.items()}
    _streams_agree("fleet live move + offload", one.backend, got, want)
    out = dict(plans=plans, at_move=at_move, live_bytes=live_bytes,
               off_bytes=off_bytes, src=src)
    del one
    _free_device_memory()
    out["gb_held_after"] = torch.cuda.memory_allocated() / 1e9
    return out, counts


async def _get_metrics(addr) -> str:
    """``GET /metrics`` from the server at ``addr``; the whole reply."""
    import asyncio
    r, w = await asyncio.open_connection(*addr)
    w.write(b"GET /metrics HTTP/1.1\r\nHost: chip-smoke\r\n\r\n")
    await w.drain()
    data = await r.read()
    w.close()
    return data.decode()


def _metric(text: str, name: str) -> float:
    """The value of the unlabelled sample ``name`` in a /metrics reply."""
    for line in text.splitlines():
        if line.startswith(name + " "):
            return float(line.split()[1])
    raise PhaseError(f"/metrics: no sample {name} in {text[:2000]!r}")


def _stream_scraped(fleet, mix) -> tuple:
    """The serve script's ``stream_all`` behind an ``AsyncServer`` that
    serves ``GET /metrics`` (``metrics_port=0``): one GET once the first
    token has been streamed (while streams are still open), one after the
    last. Returns what ``serve.stream_requests`` returns and the probe's
    readings."""
    import asyncio

    from repro_torch.launch import serve
    from repro_torch.serving.asyncfleet import AsyncServer

    async def run():
        async with AsyncServer(fleet, metrics_port=0) as srv:
            streams = asyncio.ensure_future(
                serve.stream_all(srv, fleet, mix))
            while srv.wall_metrics()["n_tokens"] == 0 and not streams.done():
                await asyncio.sleep(0.005)
            open_during = not streams.done()
            during = await _get_metrics(srv.metrics_addr)
            t0, t1, res = await streams
            after = await _get_metrics(srv.metrics_addr)
            probe = dict(addr=srv.metrics_addr, open_during=open_during,
                         during=during, after=after)
            return max(t1 - t0, 1e-9), res, srv.wall_metrics(), probe

    return asyncio.run(run())


def _fleet_wall(cfg, n: int) -> tuple:
    """``n`` engines behind ``AsyncServer`` on the wall clock (the serve
    script's ``stream_requests``, arrivals compressed 10x): the JAX fleet
    driver's 12-request mix. Every request must stream ``decode_len``
    events once. The two-engine run also serves ``GET /metrics``
    (``metrics_port=0``), read from 127.0.0.1 once while the streams run
    and once after them: both replies are Prometheus text, and after the
    run ``repro_requests_finished_total`` equals the requests streamed.
    Returns the stream summary, the streams, the kernel counts of the
    streamed run (zeroed after the warm-up) and, for the single engine,
    the engine."""
    from repro_torch.core.predictor import H100
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.serving.asyncfleet.server import _pct
    from repro_torch.serving.schemes import make_async_torch_fleet

    fleet = make_async_torch_fleet(cfg, n, dtype=torch.bfloat16, hw=H100,
                                   tick=0.1, **FLEET_KW)
    engines = [fleet.engine_of(rep) for rep in fleet.replicas]
    _warm(engines)
    mix = serve.make_requests(np.random.default_rng(0), 12, 2048)
    ops.reset_counts()
    scrape = n == 2
    try:
        if scrape:
            elapsed, res, wall, probe = _stream_scraped(fleet, mix)
        else:
            elapsed, res, wall = serve.stream_requests(fleet, mix)
    finally:
        fleet.close()
    torch.cuda.synchronize()
    counts = _fleet_counts(f"wall x{n}")
    if scrape:
        during, after = probe["during"], probe["after"]
        check(probe["addr"][0] == "127.0.0.1" and probe["open_during"],
              f"fleet wall x{n}: /metrics at {probe['addr']}, read while "
              f"streams ran: {probe['open_during']}")
        for what, text in (("during", during), ("after", after)):
            check(text.startswith("HTTP/1.1 200 OK")
                  and "version=0.0.4" in text
                  and "repro_iterations_total" in text,
                  f"fleet wall x{n}: /metrics {what} the run: "
                  f"{text[:300]!r}")
        fin_during = _metric(during, "repro_requests_finished_total")
        fin_after = _metric(after, "repro_requests_finished_total")
        check(fin_after == len(res) == len(mix) and fin_during <= fin_after,
              f"fleet wall x{n}: /metrics counted {fin_during} then "
              f"{fin_after} finished requests; {len(res)} streamed")
        print(f"[fleet] wall x{n}: GET /metrics on http://"
              f"{probe['addr'][0]}:{probe['addr'][1]} answered during the "
              f"run ({fin_during:.0f} finished, "
              f"{_metric(during, 'repro_wall_tokens_streamed_total'):.0f} "
              f"tokens streamed) and after it ({fin_after:.0f} finished = "
              f"{len(res)} streamed; {len(after.splitlines())} lines)")
    fin = sorted(r.rid for r in fleet.finished())
    check(fin == list(range(12)), f"fleet wall x{n}: finished {fin}")
    streams = {}
    for (rid, _, evs), req in zip(res, mix):
        check(rid == req.rid and [e.index for e in evs]
              == list(range(req.decode_len)),
              f"fleet wall x{n}: rid {rid} streamed "
              f"{[e.index for e in evs]} of {req.decode_len}")
        check(all(0 <= e.token < cfg.vocab_size for e in evs),
              f"fleet wall x{n}: rid {rid} streamed an id outside the "
              f"vocabulary")
        streams[rid] = [e.token for e in evs]
    _served_both_kinds(f"wall x{n}", engines)
    n_tok = sum(len(t) for t in streams.values())
    ttfts = sorted(evs[0].t - t_sub for _, t_sub, evs in res)
    tbts = sorted(b.t - a.t for _, _, evs in res
                  for a, b in zip(evs, evs[1:]))
    rep = fleet.report
    iters = [r.iterations for r in fleet.replicas]
    busy = [r.busy_time for r in fleet.replicas]
    summary = dict(
        engines=n, tokens=n_tok, wall_s=elapsed, tok_s=n_tok / elapsed,
        ttft_p50=_pct(ttfts, 50), ttft_p99=_pct(ttfts, 99),
        tbt_p50=_pct(tbts, 50), tbt_p99=_pct(tbts, 99),
        barriers=rep.ticks, migrations=rep.migrations,
        live=rep.live_migrations, offload_transfers=rep.offload_transfers,
        mb_moved=rep.kv_moved_bytes / 1e6, iterations=iters,
        ms_per_iteration=[1e3 * b / max(i, 1) for b, i in zip(busy, iters)],
        gb_peak_so_far=torch.cuda.max_memory_allocated() / 1e9)
    keep = engines[0] if n == 1 else None
    del fleet, engines
    _free_device_memory()
    summary["gb_held_after"] = torch.cuda.memory_allocated() / 1e9
    return summary, streams, counts, keep


def phase_fleet() -> dict:
    """Two full-width llama3.2-3b engines (bf16, 4 slots of 2048 tokens
    each, 64-token pages, the full KV hierarchy, seed 0) in one
    ``make_async_torch_fleet`` on the card: the deterministic part
    (``_fleet_deterministic``: a live move and an offload transfer,
    streams against one replica's) and the wall part (``_fleet_wall``:
    12 requests streamed through ``AsyncServer``; then the same mix
    through a fleet of one engine in the same run, its streams the
    reference). Both engines must have served prefill and decode rows;
    the decode, prefill and norm kernels must have launched and no plain
    version may have run, in each two-engine run and in each reference
    (``_fleet_counts``). Returns the two two-engine runs' counts added:
    each zeroed after its engines' warm-up and read right after the run,
    before its reference."""
    from repro_torch.configs import get_config

    cfg = get_config("llama3.2-3b")
    held = torch.cuda.memory_allocated() / 1e9
    det, det_counts = _fleet_deterministic(cfg)
    det["gb_held_before"] = held
    print(f"[fleet] deterministic: rid 0 moved live from replica "
          f"{det['src']} after {det['at_move']} of 40 tokens (cost model "
          f"{det['live_bytes'] / 1e6:.1f} MB); rid 100 offloaded mid-prefill "
          f"with a {det['off_bytes'] / 1e6:.2f} MB payload (1024 tokens, "
          f"payload_nbytes); plans per engine {det['plans']}; streams "
          f"agree with one make_torch_replica's")
    two, got, wall_counts, _ = _fleet_wall(cfg, 2)
    one, want, _, eng = _fleet_wall(cfg, 1)
    _streams_agree("fleet wall x2 against x1", eng, got, want)
    del eng
    _free_device_memory()
    counts = {name: {k: det_counts[name][k] + wall_counts[name][k]
                     for k in ("launches", "plain")} for name in det_counts}
    for s in (two, one):
        print(f"[fleet] wall x{s['engines']}: {s['tokens']} tokens in "
              f"{s['wall_s']:.3f} s: {s['tok_s']:.1f} tok/s; stream TTFT "
              f"p50/p99 {s['ttft_p50'] * 1e3:.1f}/{s['ttft_p99'] * 1e3:.1f} "
              f"ms, TBT p50/p99 {s['tbt_p50'] * 1e3:.1f}/"
              f"{s['tbt_p99'] * 1e3:.1f} ms; barriers {s['barriers']}, "
              f"migrations {s['migrations']} (live {s['live']}, offload "
              f"transfers {s['offload_transfers']}), {s['mb_moved']:.1f} MB "
              f"moved; iterations {s['iterations']} at "
              f"{[round(x, 2) for x in s['ms_per_iteration']]} ms each")
    print(f"[fleet] two engines against one: {two['tok_s'] / one['tok_s']:.3f}"
          f"x the tok/s; streams agree; launches of the two-engine runs: "
          f"deterministic {det_counts}, wall {wall_counts}")
    print(f"[fleet] summary {json.dumps(dict(deterministic=det, two=two, one=one))}")
    return counts


# ---------------------------------------------------------------- phase 9

class _Recorder(_FixedClock):
    """The fixed-clock shim (a constant 0.05 s an iteration, so the
    scheduler decides on virtual time alone), recording every call the
    replica makes to the engine, in order: ``("admit", rid)``,
    ``("release", rid)`` and ``("exec", ((rid, chunk, prefilled), ...),
    (decode rids))``, and each request once, so that ``_replay`` can
    drive another engine through the same plans. With ``wall`` it
    reports the engine's measured seconds instead: the replica then runs
    on the wall clock, and its plans are recorded all the same."""

    def __init__(self, inner, wall: bool = False):
        super().__init__(inner)
        self.wall = wall
        self.events = []
        self.reqs = {}

    def on_admit(self, req):
        self.reqs.setdefault(req.rid, req)
        self.inner.on_admit(req)
        self.events.append(("admit", req.rid))

    def on_release(self, req):
        self.inner.on_release(req)
        self.events.append(("release", req.rid))

    def execute(self, plan, now):
        rows = tuple((r.rid, c, r.prefilled) for r, c in plan.prefill)
        for r in [r for r, _ in plan.prefill] + list(plan.decode):
            self.reqs.setdefault(r.rid, r)
        out = super().execute(plan, now)
        self.events.append(("exec", rows,
                            tuple(r.rid for r in plan.decode)))
        return self.inner.iteration_log[-1][1] if self.wall else out


def _replay(eng, rec: _Recorder) -> float:
    """Drive ``eng`` through ``rec``'s calls, in order, with fresh copies
    of its requests; returns the wall seconds (device synchronised)."""
    from repro_torch.core.request import Request
    from repro_torch.core.scheduler import BatchPlan

    reqs = {rid: Request(rid=rid, arrival=0.0, prompt_len=r.prompt_len,
                         decode_len=r.decode_len, qos=r.qos,
                         app_id=r.app_id)
            for rid, r in rec.reqs.items()}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for kind, *args in rec.events:
        if kind == "admit":
            eng.on_admit(reqs[args[0]])
        elif kind == "release":
            eng.on_release(reqs[args[0]])
        else:
            pre, dec = args
            for rid, _, start in pre:
                reqs[rid].prefilled = start
            for rid in dec:
                reqs[rid].prefilled = reqs[rid].prompt_len
            eng.execute(BatchPlan(
                prefill=[(reqs[rid], c) for rid, c, _ in pre],
                decode=[reqs[rid] for rid in dec]), 0.0)
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def _prompt_chunks(rec: _Recorder) -> dict:
    """rid -> the chunk lengths of its last prefill from position 0, as
    the recorded plans served them."""
    chunks = {}
    for kind, *args in rec.events:
        if kind == "exec":
            for rid, c, start in args[0]:
                if start == 0:
                    chunks[rid] = []
                chunks[rid].append(c)
    return chunks


def _path_counts(what: str, kernels: tuple) -> dict:
    """The kernel counts since the last reset; fails unless every kernel
    of ``kernels`` launched and no other did, and no plain version ran."""
    from repro_torch.kernels import ops
    counts = ops.counts()
    for name, c in counts.items():
        check(c["plain"] == 0,
              f"{what}: the plain {name} ran {c['plain']} times")
        check((c["launches"] > 0) == (name in kernels),
              f"{what}: {name} launched {c['launches']} times; this path's "
              f"kernels are {kernels}")
    return counts


def _add_counts(total: dict, counts: dict) -> None:
    for name in total:
        total[name] += counts[name]["launches"]


def _recorded_fused_run(cfg, reqs, kw) -> tuple:
    """``reqs`` through a full-width fused paged replica (the factory's,
    the H100 spec, 64-token pages, quantum 32) wrapped in ``_Recorder``;
    returns the recorder (its engine: ``.inner``), its streams, its wall
    seconds and its kernel counts (zeroed after the warm-up)."""
    from repro_torch.core.predictor import H100
    from repro_torch.kernels import ops
    from repro_torch.serving.schemes import make_torch_replica

    rep = make_torch_replica("niyama", cfg, hw=H100, block_size=64,
                             quantum=32, backend_wrap=_Recorder, **kw)
    rec = rep.backend
    rec.inner.warm()
    torch.cuda.synchronize()
    ops.reset_counts()
    rep.submit_all(reqs)
    t0 = time.perf_counter()
    rep.run()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    check(len(rep.finished) == len(reqs), f"{cfg.name}: {len(rep.finished)}"
          f"/{len(reqs)} requests finished")
    counts = ops.counts()
    want = {rid: list(t) for rid, t in rec.inner.generated.items()}
    for r in reqs:
        check(len(want[r.rid]) == r.decode_len,
              f"{cfg.name}: rid {r.rid} streamed {len(want[r.rid])} of "
              f"{r.decode_len} tokens")
    return rec, want, secs, counts


def phase_reference(arch: str) -> dict:
    """Full-width ``arch`` in bf16 (8 slots of 2048 tokens, seed 0): the
    serve script's 12-request mix through the fused paged engine behind
    the NiyamaScheduler (``_recorded_fused_run``), then the same plans
    replayed into ``ReferenceTorchEngine`` and, for a model with
    attention layers, into the dense ``TorchEngine``, each built from the
    same seed (its weights checked equal). Every stream must agree with
    the paged engine's: equal, or a logged near-tie (``_streams_agree``).
    In each replay (counts zeroed just before it): the reference engine
    launches the norm kernel (and the scan for Mamba2) and no attention
    kernel, the dense engine the kernels of its path; no plain version
    runs. Returns the launches of the replays."""
    from repro_torch.engine.torch_backend import (ReferenceTorchEngine,
                                                  TorchEngine)
    from repro_torch.kernels import ops
    from repro_torch.launch import serve

    cfg = _model_config(arch)
    kw = dict(n_slots=8, max_len=2048, seed=0, dtype=torch.bfloat16,
              device="cuda")
    reqs = serve.make_requests(np.random.default_rng(0), 12, 2048)
    rec, want, fused_s, _ = _recorded_fused_run(cfg, reqs, kw)
    fused = rec.inner
    n_tok = sum(len(t) for t in want.values())
    mamba = any(l.mixer == "mamba" for l in cfg.layers)
    runs = [("reference", lambda: ReferenceTorchEngine(cfg, quantum=1, **kw),
             ("rmsnorm", "ssd_scan") if mamba else ("rmsnorm",))]
    if not mamba:
        runs.append(("dense", lambda: TorchEngine(cfg, kv_layout="dense",
                                                  quantum=32, **kw),
                     ATTENTION_PATH))
    launches = {name: 0 for name in SOURCES}
    n_exec = sum(1 for e in rec.events if e[0] == "exec")
    print(f"[reference] {arch}: the fused paged engine served {len(reqs)} "
          f"requests in {n_exec} iterations, {n_tok} output tokens in "
          f"{fused_s:.2f} s ({n_tok / fused_s:.1f} tok/s)")
    ties = {}
    for label, build_engine, kernels in runs:
        eng = build_engine()
        check(torch.equal(eng.params.embed, fused.params.embed)
              and torch.equal(eng.params.final_norm,
                              fused.params.final_norm),
              f"reference {arch} {label}: the weights differ from the "
              f"fused engine's")
        eng.warm()
        ops.reset_counts()
        secs = _replay(eng, rec)
        counts = _path_counts(f"reference {arch} {label}", kernels)
        _add_counts(launches, counts)
        got = {rid: list(t) for rid, t in eng.generated.items()}
        ties[label] = _streams_agree(f"{arch} {label} against fused paged",
                                     fused, got, want)
        print(f"[reference] {arch} {label}: the same {n_exec} plans in "
              f"{secs:.2f} s ({n_tok / secs:.1f} tok/s); streams agree with "
              f"the fused paged engine's, {ties[label]} of {len(reqs)} at a "
              f"logged bf16 near-tie; launches {counts}")
        del eng
        _free_device_memory()
    del fused
    _free_device_memory()
    if not mamba:
        for name, n in _f32_replay(cfg, rec, ties).items():
            launches[name] += n
    del rec
    _free_device_memory()
    return launches


# the f32 replay's depth: llama3.2-3b at full width, 4 of its 28 layers
F32_REPLAY_LAYERS = 4


def _f32_replay(cfg, rec: _Recorder, bf16_ties: dict) -> dict:
    """The near-tie check: ``cfg`` cut to ``F32_REPLAY_LAYERS`` layers at
    full width, f32 weights from seed 0 (TF32 off, as everywhere here),
    driven through the bf16 run's recorded plans (``rec``) by the fused
    paged engine, then by ``ReferenceTorchEngine`` and the dense
    ``TorchEngine``. Their streams must equal the fused paged engine's
    with no near-tie allowance: in f32 the engines differ by summation
    order alone (about 1e-6), far below any gap a greedy pick meets at
    random, so a divergence here is a fault, not a tie. Returns the three
    replays' launches (each zeroed just before it)."""
    from repro_torch.engine.torch_backend import (ReferenceTorchEngine,
                                                  TorchEngine)
    from repro_torch.kernels import ops

    cut = dataclasses.replace(cfg, num_layers=F32_REPLAY_LAYERS,
                              layers=cfg.layers[:F32_REPLAY_LAYERS])
    kw = dict(n_slots=8, max_len=2048, seed=0, dtype=torch.float32,
              device="cuda")
    launches = {name: 0 for name in SOURCES}
    builds = (("fused paged", lambda: TorchEngine(cut, quantum=32,
                                                  block_size=64, **kw),
               ATTENTION_PATH),
              ("reference", lambda: ReferenceTorchEngine(cut, quantum=1,
                                                         **kw),
               ("rmsnorm",)),
              ("dense", lambda: TorchEngine(cut, kv_layout="dense",
                                            quantum=32, **kw),
               ATTENTION_PATH))
    want, first, line = None, None, []
    for label, build_engine, kernels in builds:
        eng = build_engine()
        eng.warm()
        ops.reset_counts()
        secs = _replay(eng, rec)
        _add_counts(launches, _path_counts(
            f"f32 replay {label}", kernels))
        got = {rid: list(t) for rid, t in eng.generated.items()}
        if want is None:
            want = got
            first = eng
        else:
            _streams_agree(f"f32 {label} against fused paged", first, got,
                           want, near_tie=False)
        line.append(f"{label} {secs:.2f} s")
        if eng is not first:
            del eng
            _free_device_memory()
    n_tok = sum(len(t) for t in want.values())
    print(f"[reference] f32 replay of {cfg.name} at {F32_REPLAY_LAYERS} of "
          f"{cfg.num_layers} layers, full width, TF32 off, on the bf16 "
          f"run's {sum(1 for e in rec.events if e[0] == 'exec')} plans: "
          f"{len(want)} requests, {n_tok} tokens, 0 divergences of the "
          f"reference and dense engines from the fused paged engine (no "
          f"near-tie allowed; {', '.join(line)}); bf16 at full depth: "
          f"{bf16_ties} requests passed at a near-tie")
    del first
    _free_device_memory()
    return launches


# whisper-medium's serve run: requests of 16-128 prompt and 8-32 output
# tokens under max_len 512
WHISPER_REQUESTS = 8


def phase_whisper() -> dict:
    """Full-width whisper-medium (24 encoder and 24 decoder layers,
    d_model 1024, 16 heads of 64, vocab 51865 padded to 51968; bf16,
    seed 0) through ``ReferenceTorchEngine`` behind the NiyamaScheduler
    (``make_torch_replica(engine="reference")``, 8 slots, max_len 512,
    the H100 spec): ``WHISPER_REQUESTS`` requests, every one finished with
    all its tokens inside the vocabulary; the norm kernel launched (counts
    zeroed just before the run), no other kernel, no plain version. The
    encoder reruns on every prefill call, as in JAX: its time is measured
    alone with CUDA events. Then ``_whisper_parity``. Returns the run's
    launches."""
    from repro_torch.configs import get_config
    from repro_torch.core.predictor import H100
    from repro_torch.core.request import Request
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    from repro_torch.serving.schemes import CPU_TIERS, make_torch_replica

    cfg = get_config("whisper-medium")
    rep = make_torch_replica("niyama", cfg, engine="reference", n_slots=8,
                             max_len=512, hw=H100, device="cuda",
                             dtype=torch.bfloat16, seed=0)
    eng = rep.backend
    eng.warm()
    rng = np.random.default_rng(0)
    reqs = []
    arrivals = np.sort(rng.uniform(0, WHISPER_REQUESTS,
                                   WHISPER_REQUESTS))
    for i, t in enumerate(arrivals):
        q = CPU_TIERS[i % 3]
        reqs.append(Request(rid=i, arrival=float(t),
                            prompt_len=int(rng.integers(16, 129)),
                            decode_len=int(rng.integers(8, 33)), qos=q,
                            app_id=q.name, important=bool(i % 5)))
    torch.cuda.synchronize()
    ops.reset_counts()
    rep.submit_all(reqs)
    t0 = time.perf_counter()
    rep.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _path_counts("whisper-medium", ("rmsnorm",))
    check(len(rep.finished) == len(reqs),
          f"whisper-medium: {len(rep.finished)}/{len(reqs)} finished")
    for r in reqs:
        toks = eng.generated[r.rid]
        check(len(toks) == r.decode_len
              and all(0 <= t < cfg.vocab_size for t in toks),
              f"whisper-medium: rid {r.rid} streamed {toks}")
    n_tok = sum(len(eng.generated[r.rid]) for r in reqs)
    n_prompt = sum(r.prompt_len for r in reqs)
    calls = sum(len(c.prefill_items) for c, _ in eng.iteration_log)
    frames = eng._extras(1)["frames"]
    with torch.inference_mode():
        enc_ms = _call_ms(lambda: T._encoder_forward(eng.params, cfg,
                                                     frames))
    print(f"[whisper] whisper-medium, {cfg.param_count() / 1e9:.3f}e9 "
          f"parameters ({cfg.encoder.num_layers} encoder + "
          f"{cfg.num_layers} decoder layers, d_model {cfg.d_model}, vocab "
          f"{cfg.vocab_size} padded to {cfg.vocab_padded}), bf16, reference "
          f"engine: {len(reqs)} requests, {n_prompt} prompt + {n_tok} output "
          f"tokens in {rep.iterations} iterations, {wall:.2f} s wall: "
          f"{n_tok / wall:.1f} output tok/s; {calls} prefill calls, the "
          f"encoder {enc_ms:.3f} ms a call (fp32 frames; CUDA events from "
          f"an idle device, host queueing included), "
          f"{calls * enc_ms / 1e3 / wall:.1%} of the wall time; rmsnorm "
          f"launches {counts['rmsnorm']['launches']}")
    del rep, eng, frames
    _free_device_memory()
    _whisper_parity()
    return {name: c["launches"] for name, c in counts.items()}


def _whisper_parity() -> None:
    """Whisper-medium at full width cut to 2 encoder and 2 decoder
    layers, f32 (TF32 off): one prefill of 64 tokens carrying random
    (non-zero) frames, so that the encoder and the cross caches carry
    data, through the norm kernel and through the plain versions: logits
    within 1e-4 (the norm in f32 differs by a few ulps, carried through
    four layers) and the same argmax at every position, or a logged
    near-tie (a plain top-2 gap under ``NEAR_TIE_LOGIT``)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    from repro_torch.models.config import EncoderConfig

    full = get_config("whisper-medium")
    cfg = dataclasses.replace(full, num_layers=2, layers=full.layers[:2],
                              encoder=EncoderConfig(2, 1500))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(11)
    params = T.init_params(cfg, gen, "cuda", torch.float32)
    frames = torch.randn((1, 1500, cfg.d_model), generator=gen,
                         device="cuda")
    toks = torch.randint(0, cfg.vocab_size, (1, 64), generator=gen,
                         device="cuda", dtype=torch.int32)
    outs = []
    for plain in (False, True):
        cache = T.init_cache(cfg, 1, 128, dtype=torch.float32, chunk=128,
                             device="cuda")
        with ops.plain_versions() if plain else contextlib.nullcontext():
            lg, _ = T.prefill(params, cfg, cache, toks,
                              torch.zeros((1,), dtype=torch.int32,
                                          device="cuda"),
                              batch_extras={"frames": frames})
        outs.append(lg[0, :, :cfg.vocab_size].float())
    got, want = outs
    err = float((got - want).abs().max())
    top = torch.topk(want, 2, dim=-1).values
    gap = top[:, 0] - top[:, 1]
    flips = (got.argmax(-1) != want.argmax(-1)).nonzero().flatten().tolist()
    check(err <= 1e-4 and all(float(gap[i]) < NEAR_TIE_LOGIT for i in flips),
          f"whisper parity: |logits kernel - plain| {err:.3g}, argmax "
          f"differs at {flips} (plain top-2 gaps "
          f"{[float(gap[i]) for i in flips]})")
    print(f"[whisper] parity, 2 + 2 layers at full width, f32, random "
          f"frames: max |logits kernel - plain| {err:.3g}; argmax equal at "
          f"{64 - len(flips)} of 64 positions"
          + (f", near-ties at {flips}" if flips else ""))


# internvl2-76b at full width, cut to its first 4 of 80 layers so that one
# card holds it (70.6e9 parameters, 141 GB in bf16, in full)
INTERNVL_LAYERS = 4


def phase_internvl2() -> dict:
    """internvl2-76b at full width (d_model 8192, 64 / 8 heads of 128,
    d_ff 28672, vocab 128256) cut to ``INTERNVL_LAYERS`` layers, bf16,
    seed 0, with the vision stub (each prefill chunk's leading 256
    positions carry zero patch embeddings): 6 requests of the serve
    script's mix through the fused paged engine (``_recorded_fused_run``;
    the attention kernels and the norm launched, counts zeroed after the
    warm-up), then the same plans replayed into ``ReferenceTorchEngine``
    (the norm kernel alone); the streams must agree (``_streams_agree``).
    Returns both runs' launches."""
    from repro_torch.configs import get_config
    from repro_torch.engine.torch_backend import ReferenceTorchEngine
    from repro_torch.kernels import ops
    from repro_torch.launch import serve

    full = get_config("internvl2-76b")
    cfg = dataclasses.replace(full, num_layers=INTERNVL_LAYERS,
                              layers=full.layers[:INTERNVL_LAYERS])
    cut = (f"{INTERNVL_LAYERS} of {full.num_layers} layers, "
           f"{cfg.param_count() / 1e9:.2f}e9 of "
           f"{full.param_count() / 1e9:.1f}e9 parameters")
    kw = dict(n_slots=8, max_len=2048, seed=0, dtype=torch.bfloat16,
              device="cuda")
    reqs = serve.make_requests(np.random.default_rng(1), 6, 2048)
    rec, want, fused_s, counts = _recorded_fused_run(cfg, reqs, kw)
    fused = rec.inner
    for name, c in counts.items():
        check(c["plain"] == 0 and (c["launches"] > 0) ==
              (name in ATTENTION_PATH),
              f"internvl2-76b fused: {name} {c}")
    launches = {name: 0 for name in SOURCES}
    _add_counts(launches, counts)
    n_tok = sum(len(t) for t in want.values())
    ref = ReferenceTorchEngine(cfg, quantum=1, **kw)
    check(torch.equal(ref.params.embed, fused.params.embed),
          "internvl2-76b: the reference engine's weights differ")
    ref.warm()
    ops.reset_counts()
    secs = _replay(ref, rec)
    rcounts = _path_counts("internvl2-76b reference", ("rmsnorm",))
    _add_counts(launches, rcounts)
    got = {rid: list(t) for rid, t in ref.generated.items()}
    _streams_agree("internvl2-76b reference against fused paged", fused,
                   got, want, chunks=_prompt_chunks(rec))
    print(f"[internvl2] internvl2-76b at full width, {cut}, bf16, vision "
          f"stub of {cfg.frontend.num_tokens} patches: {len(reqs)} requests, "
          f"{n_tok} output tokens; fused paged {fused_s:.2f} s "
          f"({n_tok / fused_s:.1f} tok/s), reference {secs:.2f} s "
          f"({n_tok / secs:.1f} tok/s) on the same plans; streams agree; "
          f"launches fused {counts}, reference {rcounts}")
    del ref, rec, fused
    _free_device_memory()
    return launches


# ---------------------------------------------------------------- phase 12

# (a)'s requests: the first of the serve phase's 12
OBS_INERT_REQUESTS = 6
OBS_OUT = ROOT / "chiprun_out"


def _obs_replica(traced: bool) -> tuple:
    """The serve phase's llama3.2-3b replica (``_replica``: bf16, 8 slots
    of 2048 tokens, 64-token pages, the H100 spec) behind the fixed-clock
    shim, its scheduler wrapped in the plan recorder
    (``sim.trace.TraceRecorder``); with ``traced``, also a lifecycle
    ``TraceRecorder`` (``install_tracer``), which turns on the
    scheduler's verdict detail (``BatchPlan.trace``)."""
    from repro_torch.obs import TraceRecorder, install_tracer
    from repro_torch.sim.trace import TraceRecorder as PlanRecorder

    rep = _replica("llama3.2-3b", "niyama", kv_quant=False)
    rep.backend = _FixedClock(rep.backend)
    plans = PlanRecorder(rep.scheduler)
    rep.scheduler = plans
    rec = install_tracer(rep, TraceRecorder()) if traced else None
    return rep, plans, rec


def _obs_inertness(launches: dict) -> dict:
    """(a) ``OBS_INERT_REQUESTS`` of the serve phase's requests through
    ``_obs_replica``, untraced then traced: the plan digests
    (``sim.trace.trace_digest``) and the token streams must be equal.
    Each run's kernel counts are zeroed after its warm-up and read after
    it (the attention path's kernels, no plain version). Returns each
    run's host wall ms per iteration."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.obs import validate_events
    from repro_torch.sim.trace import trace_digest

    out = {}
    for traced in (False, True):
        rep, plans, rec = _obs_replica(traced)
        rep.backend.inner.warm()
        torch.cuda.synchronize()
        reqs = serve.make_requests(np.random.default_rng(0), 12,
                                   2048)[:OBS_INERT_REQUESTS]
        ops.reset_counts()
        rep.submit_all(reqs)
        t0 = time.perf_counter()
        rep.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        label = "traced" if traced else "untraced"
        _add_counts(launches, _path_counts(f"obs (a) {label}",
                                           ATTENTION_PATH))
        check(len(rep.finished) == len(reqs),
              f"obs (a) {label}: {len(rep.finished)}/{len(reqs)} finished")
        if traced:
            evs = rec.events()
            check(validate_events(evs) == [] and any(
                e["kind"] == "iter" and e["sched"] is not None
                for e in evs), f"obs (a): the traced run recorded "
                f"{len(evs)} events, {validate_events(evs)[:3]}")
        out[label] = dict(
            digest=trace_digest(plans.lines), iterations=rep.iterations,
            ms_per_iteration=1e3 * wall / max(rep.iterations, 1),
            streams={rid: list(t) for rid, t in
                     rep.backend.inner.generated.items()},
            events=len(rec) if traced else 0)
        del rep, plans, rec
        _free_device_memory()
    a, b = out["untraced"], out["traced"]
    check(a["digest"] == b["digest"] and a["iterations"] == b["iterations"],
          f"obs (a): the traced run planned otherwise: {a['digest']} "
          f"({a['iterations']} iterations) against {b['digest']} "
          f"({b['iterations']})")
    check(a["streams"] == b["streams"],
          "obs (a): the traced run streamed other tokens")
    print(f"[obs] (a) inertness at full width: {OBS_INERT_REQUESTS} requests, "
          f"{a['iterations']} iterations under the fixed clock, plan digest "
          f"{a['digest'][:16]} untraced and traced, streams equal; host wall "
          f"{a['ms_per_iteration']:.2f} ms an iteration untraced, "
          f"{b['ms_per_iteration']:.2f} ms traced ({b['events']} events)")
    return out


def _obs_wall(launches: dict) -> dict:
    """(b) the serve phase's 12 requests through the serve script with
    ``--trace-out`` and ``--trace-chrome`` on the wall clock: the JSONL
    must validate, every request's breakdown must sum to its end-to-end
    latency within 1e-9 s, and the replica's scrape must mirror its
    iterations and the engine's prefill tokens. Prints the attribution
    table (the script does) and the per-cause totals."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.obs import (CAUSES, Attribution, MetricsRegistry,
                                 attribute, scrape_replica, validate_events)

    OBS_OUT.mkdir(exist_ok=True)
    jsonl, chrome = OBS_OUT / "obs_trace.jsonl", OBS_OUT / "obs_trace.json"
    ops.reset_counts()
    with _counts_after_warm():
        rep = serve.main(["--arch", "llama3.2-3b", "--device", "cuda",
                          "--dtype", "bf16", "--n-requests", "12",
                          "--max-len", "2048", "--slots", "8", "--seed", "0",
                          "--trace-out", str(jsonl), "--trace-chrome",
                          str(chrome)])
    torch.cuda.synchronize()
    _add_counts(launches, _path_counts("obs (b)", ATTENTION_PATH))
    rec, eng = rep.tracer, rep.backend
    reqs = rep.all_requests()
    check(rec is not None and len(rep.finished) == len(reqs) == 12,
          f"obs (b): {len(rep.finished)}/{len(reqs)} finished, recorder "
          f"{rec}")
    evs = [json.loads(line) for line in jsonl.read_text().splitlines()]
    errs = validate_events(evs)
    check(errs == [] and len(evs) == len(rec) and rec.dropped == 0,
          f"obs (b): {len(evs)} JSONL events of {len(rec)}, "
          f"{rec.dropped} dropped, schema errors {errs[:3]}")
    check(len(json.loads(chrome.read_text())["traceEvents"]) == len(evs),
          "obs (b): the Chrome trace lost events")
    att = Attribution(rec)
    totals = {c: 0.0 for c in ("service",) + tuple(CAUSES)}
    e2e = 0.0
    for r in reqs:
        ex = att.explain(r.rid)
        gap = abs(sum(ex["breakdown"].values()) - ex["e2e"])
        check(ex["finished"] and gap <= 1e-9,
              f"obs (b): rid {r.rid}'s breakdown misses its end-to-end "
              f"latency by {gap:.3g} s: {ex}")
        e2e += ex["e2e"]
        for c, v in ex["breakdown"].items():
            totals[c] += v
    summ = attribute(rec, reqs)
    iters = [e for e in evs if e["kind"] == "iter"]
    elapsed = sum(e["elapsed"] for e in iters)
    predicted = sum(e["predicted"] for e in iters)
    reg = MetricsRegistry()
    scrape_replica(reg, rep)
    it_total = reg.get("repro_iterations_total").value(replica=0)
    pt_total = reg.get("repro_engine_prefill_tokens_total").value(replica=0)
    check(it_total == rep.iterations and pt_total == eng.prefill_tokens > 0,
          f"obs (b): scrape gives {it_total} iterations against "
          f"{rep.iterations}, {pt_total} prefill tokens against "
          f"{eng.prefill_tokens}")
    print(f"[obs] (b) wall run: {len(reqs)} requests, {rep.iterations} "
          f"iterations, {len(evs)} events ({jsonl.name}, {chrome.name}); "
          f"every breakdown sums to its end-to-end latency within 1e-9 s; "
          f"{summ['n_violated']} violated; scrape: repro_iterations_total "
          f"{it_total:.0f}, repro_engine_prefill_tokens_total "
          f"{pt_total:.0f} (= the engine's)")
    print(f"[obs] (b) seconds by cause over the {len(reqs)} requests' "
          f"{e2e:.4f} s of end-to-end latency: "
          + ", ".join(f"{c} {v:.4f}" for c, v in totals.items()))
    n_it = len(iters)
    print(f"[obs] (b) iterations: measured {elapsed:.4f} s, the H100 cost "
          f"model predicted {predicted:.4f} s ({1e3 * elapsed / n_it:.2f} "
          f"against {1e3 * predicted / n_it:.2f} ms an iteration)")
    out = dict(requests=len(reqs), iterations=rep.iterations,
               events=len(evs), violated=summ["n_violated"],
               causes=summ["causes"], e2e_s=e2e, by_cause_s=totals,
               elapsed_s=elapsed, predicted_s=predicted)
    del rep, rec, eng
    _free_device_memory()
    return out


def phase_obs() -> dict:
    """The observability plane on the serve path: (a) the recorder's
    inertness on the card (``_obs_inertness``) and (b) a traced wall run
    through the serve script (``_obs_wall``). Returns the launches of its
    three runs."""
    launches = {name: 0 for name in SOURCES}
    inert = _obs_inertness(launches)
    for run in inert.values():
        del run["streams"]
    wall = _obs_wall(launches)
    print(f"[obs] summary {json.dumps(dict(inert=inert, wall=wall))}")
    print(f"[obs] launches {launches}")
    return launches


# ---------------------------------------------------------------- main


# ---------------------------------------------------------------- train

TRAIN_PATH = ("rmsnorm", "rmsnorm_bwd")
MAMBA_TRAIN_PATH = TRAIN_PATH + ("ssd_scan", "ssd_scan_bwd")
TRAIN_B, TRAIN_S = 2, 512
# the Mamba runs: four 256-token chunks a row, so the state's gradient
# crosses chunks
MAMBA_TRAIN_S = 1024
TRAIN_PARITY_LAYERS = 4
# jamba-v0.1-52b's first two layers: a Mamba layer with a dense FFN and
# one with the 16-expert MoE (~3.7 B parameters, ~45 GB in f32 with two
# gradient sets held)
JAMBA_PARITY_LAYERS = 2
# f32 (TF32 off) gradient parity, kernels against plain versions over 4
# full-width layers: the two differ only in the norms' last bits (a few
# ulps forward and backward), which a 4-layer network carries into the
# loss and the gradients without growing them by orders; a dropped norm
# gradient would be O(1) of its leaf. The Mamba runs are held to the same
# limits: the scan's kernels differ from its plain versions by the
# summation order of the chunk's decay (SSD_REL of each output), which
# the loss and gradients see diluted by the layers around it
TRAIN_LOSS_REL = 1e-5
TRAIN_GRAD_REL = 1e-4     # of each leaf's largest magnitude
TRAIN_STEPS = 3
TRAIN_SCRIPT_ARCHS = ("llama3.2-3b", "qwen3-moe-30b-a3b", "gemma3-4b",
                      "mamba2-370m", "jamba-v0.1-52b")
# small_100m's task (vocab 32768, 8 x 128 tokens a step, lr 1e-3) lowers
# the loss only after ~150 optimizer steps, in JAX's training script as
# in the port's (PERF.md): 40 steps leave it at ln V's level or above.
# The Mamba families lower it from the first logged steps (PR 23: 10.56
# -> 9.45 by step 40, 3.57 by step 199), so their runs stop at 60
TRAIN_SCRIPT_STEPS = 200
MAMBA_SCRIPT_STEPS = 60


def _train_path(cfg) -> tuple:
    """The kernels a training step of ``cfg`` launches: the norm's two,
    and the scan's two where it has a Mamba layer."""
    mamba = any(spec.mixer == "mamba" for spec in cfg.layers)
    return MAMBA_TRAIN_PATH if mamba else TRAIN_PATH


def _predicted_launches(cfg, steps: int) -> dict:
    """Each kernel's launches in ``steps`` steps with remat: every forward
    kernel twice a layer (the step and the recompute), every backward
    once, and the final norm once each way. A layer has its pre-norm and,
    with an FFN, a second norm; a Mamba layer one scan."""
    norms = sum(1 + (spec.ffn != "none") for spec in cfg.layers)
    scans = sum(spec.mixer == "mamba" for spec in cfg.layers)
    return {"rmsnorm": steps * (2 * norms + 1),
            "rmsnorm_bwd": steps * (norms + 1),
            "ssd_scan": steps * 2 * scans, "ssd_scan_bwd": steps * scans}


def _loss_and_grads(params, cfg, batch):
    from repro_torch.engine.steps import cross_entropy
    from repro_torch.models.transformer import forward_train
    logits, _ = forward_train(params, cfg, batch, remat=True)
    loss = cross_entropy(logits, batch["labels"], cfg.vocab_size)
    grads = torch.autograd.grad(loss, list(params.parameters()))
    return loss.detach(), grads


def _train_parity(arch: str, layers: int, seq: int) -> None:
    """One loss and its gradients through the kernels, against the same
    under ``ops.plain_versions()``: ``arch`` at full width, its first
    ``layers`` layers, f32 with TF32 off, a ``TRAIN_B`` x ``seq`` batch.
    The kernel run's counts are read (not added to the path's launches:
    the run is a comparison)."""
    from repro_torch.engine.steps import init_train_state
    from repro_torch.kernels import ops
    from repro_torch.launch.train import synthetic_batch

    cfg = _model_config(arch)
    cut = dataclasses.replace(cfg, num_layers=layers,
                              layers=cfg.layers[:layers])
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    # the optimizer state (two moments a parameter) is not needed here
    params = init_train_state(cut, gen, device="cuda")[0]
    n = sum(p.numel() for p in params.parameters())
    batch = synthetic_batch(np.random.default_rng(0), cut, TRAIN_B, seq,
                            "cuda")
    path = _train_path(cut)
    ops.reset_counts()
    loss_k, grads_k = _loss_and_grads(params, cut, batch)
    torch.cuda.synchronize()
    counts = _path_counts(f"train parity {arch}, kernel run", path)
    with ops.plain_versions():
        loss_p, grads_p = _loss_and_grads(params, cut, batch)
    peak = torch.cuda.max_memory_allocated() / 1e9
    loss_rel = float((loss_k - loss_p).abs() / loss_p.abs())
    rels = {}
    for (name, _), gk, gp in zip(params.named_parameters(), grads_k,
                                 grads_p):
        rels[name] = float((gk - gp).abs().max()
                           / gp.abs().max().clamp_min(1e-30))
        check(bool(torch.isfinite(gk).all()),
              f"train parity {arch}: {name}'s gradient is not finite")
    ranked = sorted(rels.items(), key=lambda kv: -kv[1])
    worst_name, worst = ranked[0]
    named = dict(zip((k for k, _ in params.named_parameters()), grads_k))
    watched = {k: float(g.abs().max()) for k, g in named.items()
               if "norm" in k or k.endswith(("A_log", "dt_bias"))}
    print(f"[train] parity, {arch} full width, {layers} of "
          f"{cfg.num_layers} layers ({n / 1e9:.3f} B parameters), f32, "
          f"batch {TRAIN_B} x {seq}: loss {float(loss_k):.6f} kernels "
          f"against {float(loss_p):.6f} plain, relative {loss_rel:.3g} "
          f"(limit {TRAIN_LOSS_REL}); largest gradient difference "
          f"{worst:.3g} of its leaf's largest magnitude ({worst_name}; "
          f"limit {TRAIN_GRAD_REL}); the largest gradients of the norm "
          f"weights and the scan's A_log and dt_bias: "
          f"{max(watched.values()):.3g}; the next largest differences "
          + ", ".join(f"{k} {v:.3g}" for k, v in ranked[1:4])
          + "; launches "
          + ", ".join(f"{k} {counts[k]['launches']}" for k in path)
          + f"; peak device memory {peak:.2f} GB")
    check(loss_rel <= TRAIN_LOSS_REL and worst <= TRAIN_GRAD_REL
          and all(v > 0 for v in watched.values()),
          f"train parity {arch}: loss {loss_rel:.3g}, gradients {worst:.3g} "
          f"({worst_name}) of their limits' units; watched {watched}")
    del params, grads_k, grads_p
    _free_device_memory()


# the kernels of a training step, as the profiler names them: (label,
# name fragments)
TRAIN_PROFILE = (("scan forward", ("ssd_chunk_state_kernel",
                                   "ssd_state_pass_kernel",
                                   "ssd_chunk_scan_kernel")),
                 ("scan backward", ("ssd_bwd_",)),
                 ("norm forward", ("rmsnorm_kernel",)),
                 ("norm backward", ("rmsnorm_bwd_kernel",
                                    "rmsnorm_dw_kernel")))


def _profile_step(arch: str, step, params, opt, batch,
                  step_ms: float) -> None:
    """One more training step under ``torch.profiler``: its wall ms, the
    device's busy ms and its idle share of the profiled wall and of
    ``step_ms`` (an unprofiled step's median wall: the profiler slows the
    host's dispatch), and device ms by kernel: the scan's forward and
    backward, the norm's two directions, GEMMs and the rest (the step's
    elementwise ops, AdamW, the loss), with the five largest kernels of
    the rest by name."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        step(params, opt, batch)
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t) * 1e3
    events = [e for e in prof.key_averages() if _device_us(e) > 0]
    kernels = {e.key: _device_us(e) / 1e3 for e in events}
    busy = sum(kernels.values())
    if busy == 0:
        print(f"[train] profiled {arch} step: {wall:.1f} ms wall; device "
              f"time not measured (the profiler saw no kernel)")
        return
    parts, seen = {}, set()
    for label, frags in TRAIN_PROFILE:
        keys = [k for k in kernels if any(f in k for f in frags)]
        parts[label] = sum(kernels[k] for k in keys)
        seen.update(keys)
    gemm = [k for k in kernels if k not in seen and any(
        w in k.lower() for w in ("gemm", "cutlass", "sm90_xmma", "nvjet"))]
    parts["GEMMs"] = sum(kernels[k] for k in gemm)
    seen.update(gemm)
    rest = {k: v for k, v in kernels.items() if k not in seen}
    parts["other"] = sum(rest.values())
    print(f"[train] profiled {arch} f32 step, batch {TRAIN_B} x "
          f"{MAMBA_TRAIN_S}: {wall:.1f} ms wall (profiler on), "
          f"{sum(e.count for e in events)} kernels, device busy "
          f"{busy:.2f} ms (idle share {max(0.0, 1 - busy / wall):.1%}; of "
          f"an unprofiled step's {step_ms:.1f} ms, "
          f"{max(0.0, 1 - busy / step_ms):.1%}); "
          f"device ms by kernel: " + ", ".join(
              f"{k} {v:.2f}" for k, v in parts.items()))
    for k, v in sorted(rest.items(), key=lambda kv: -kv[1])[:5]:
        print(f"[train]   other: {v:.3f} ms  {k[:90]}")


def _train_full(arch: str, seq: int, watch_names: tuple,
                expect_gb: str, profile: bool = False) -> dict:
    """``TRAIN_STEPS`` AdamW steps of ``arch`` at full width and full
    depth in f32 (the dtype of the JAX training script) through
    ``make_train_step``, remat on, batch ``TRAIN_B`` x ``seq``; the counts
    zeroed just before the steps and read just after. With ``profile``,
    one more step under the profiler after the counts are read
    (``_profile_step``)."""
    from repro_torch.engine.steps import init_train_state, make_train_step
    from repro_torch.kernels import ops
    from repro_torch.launch.train import synthetic_batch

    cfg = _model_config(arch)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    params, opt = init_train_state(cfg, gen, device="cuda")
    n = sum(p.numel() for p in params.parameters())
    print(f"[train] {arch} full: {n / 1e9:.3f} B parameters, "
          f"{cfg.num_layers} layers, d_model {cfg.d_model}, vocab "
          f"{cfg.vocab_size}; expected peak: {16 * n / 1e9:.1f} GB of "
          f"parameters, gradients and moments (16 bytes a parameter) "
          f"{expect_gb}")
    rng = np.random.default_rng(0)
    batches = [synthetic_batch(rng, cfg, TRAIN_B, seq, "cuda")
               for _ in range(TRAIN_STEPS)]
    step = make_train_step(cfg)
    # the leading rows of a few leaves, to see the parameters move
    watch = {k: v.detach()[:8].clone() for k, v in params.named_parameters()
             if k in watch_names}
    path = _train_path(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_counts()
    losses, secs = [], []
    for b in batches:
        t = time.perf_counter()
        params, opt, m = step(params, opt, b)
        loss = float(m["loss"])
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t)
        losses.append(loss)
    counts = _path_counts(f"train {arch} full", path)
    peak = torch.cuda.max_memory_allocated() / 1e9
    moved = {k: float((dict(params.named_parameters())[k].detach()[:8] - v)
                      .abs().max()) for k, v in watch.items()}
    want = _predicted_launches(cfg, TRAIN_STEPS)
    tok = TRAIN_B * seq
    print(f"[train] {arch} full, f32, batch {TRAIN_B} x {seq}: losses "
          f"{[round(x, 4) for x in losses]}, seconds a step "
          f"{[round(x, 3) for x in secs]} (the first warms up), "
          f"{tok / float(np.median(secs)):.0f} tokens/s at the median, peak "
          f"device memory {peak:.2f} GB; largest parameter moves {moved}; "
          f"launches " + ", ".join(
              f"{k} {counts[k]['launches']} (predicted {want[k]})"
              for k in path))
    check(len(watch) == len(watch_names) and all(np.isfinite(losses)),
          f"train {arch} full: losses {losses}, watched {list(watch)}")
    check(all(v > 0 for v in moved.values()),
          f"train {arch} full: parameters did not move: {moved}")
    check(all(counts[k]["launches"] == want[k] for k in path),
          f"train {arch} full: launches {counts}, predicted {want}")
    if profile:
        _profile_step(arch, step, params, opt, batches[0],
                      float(np.median(secs[1:])) * 1e3)
    del params, opt, batches, watch
    _free_device_memory()
    return counts


def _train_script(ck: Path) -> tuple:
    """``repro_torch.launch.train`` as a user runs it, on the card, for
    each of ``TRAIN_SCRIPT_ARCHS`` at ``small_100m``: each run's counts
    zeroed just before it and read just after; its loss trajectory beside
    ln V, the last logged loss below the first. The llama run writes the
    checkpoint ``ck``; returns the summed counts and that run's state."""
    import contextlib as _cl
    import io

    from repro_torch.kernels import ops
    from repro_torch.launch import train

    total = {name: 0 for name in SOURCES}
    state = None
    for arch in TRAIN_SCRIPT_ARCHS:
        cfg = train.small_100m(_model_config(arch))
        steps = TRAIN_SCRIPT_STEPS if _train_path(cfg) == TRAIN_PATH \
            else MAMBA_SCRIPT_STEPS
        argv = ["--arch", arch, "--steps", str(steps),
                "--log-every", "20", "--device", "cuda"]
        if arch == "llama3.2-3b":
            argv += ["--checkpoint", str(ck)]
        out = io.StringIO()
        ops.reset_counts()
        t = time.perf_counter()
        with _cl.redirect_stdout(out):
            params, opt, _ = train.main(argv)
        secs = time.perf_counter() - t
        counts = _path_counts(f"train script {arch}", _train_path(cfg))
        _add_counts(total, counts)
        lines = out.getvalue().splitlines()
        losses = [float(line.split()[3]) for line in lines
                  if line.startswith("step ")]
        print(f"[train] python -m repro_torch.launch.train "
              f"{' '.join(argv)}: {secs:.1f} s")
        for line in lines:
            print(f"[train]   {line}")
        print(f"[train]   losses {losses} against ln V "
              f"{np.log(cfg.vocab_size):.4f}"
              f"; launches " + ", ".join(
                  f"{k} {c['launches']}" for k, c in counts.items()
                  if c["launches"]))
        check(len(losses) >= 2 and all(np.isfinite(losses))
              and losses[-1] < losses[0],
              f"train script {arch}: the loss did not fall: {losses}")
        if arch == "llama3.2-3b":
            state = (params, opt)
        else:
            del params, opt
    return total, state


def _train_checkpoint(ck: Path, state) -> None:
    """The llama run's checkpoint restored into a fresh state equals the
    state in memory; one step from each, on the same batch, gives the same
    loss and parameters bit for bit."""
    from repro_torch.engine.checkpoint import restore_checkpoint
    from repro_torch.engine.steps import init_train_state, make_train_step
    from repro_torch.launch import train

    params, opt = state
    cfg = train.small_100m(_model_config("llama3.2-3b"))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    fresh, fopt = init_train_state(cfg, gen, device="cuda")
    t = time.perf_counter()
    fresh, fopt, step = restore_checkpoint(ck, fresh, fopt)
    restore_s = time.perf_counter() - t
    check(step == TRAIN_SCRIPT_STEPS and int(fopt.step) == int(opt.step),
          f"train checkpoint: step {step}, optimizer step {int(fopt.step)}")
    for (n, a), b in zip(params.named_parameters(), fresh.parameters()):
        check(torch.equal(a, b), f"train checkpoint: {n} differs")
    for k in opt.mu:
        check(torch.equal(opt.mu[k], fopt.mu[k])
              and torch.equal(opt.nu[k], fopt.nu[k]),
              f"train checkpoint: the moments of {k} differ")
    batch = train.synthetic_batch(np.random.default_rng(99), cfg, 8, 128,
                                  "cuda")
    step_fn = make_train_step(cfg, lr=1e-3)
    _, _, m_mem = step_fn(params, opt, batch)
    _, _, m_res = step_fn(fresh, fopt, batch)
    diff = {n: float((a - b).detach().abs().max()) for (n, a), b in
            zip(params.named_parameters(), fresh.parameters())
            if not torch.equal(a, b)}
    print(f"[train] checkpoint {ck.name} ({ck.stat().st_size / 1e9:.2f} GB) "
          f"restored in {restore_s:.1f} s, equal to the state in memory; "
          f"one step from each: loss {float(m_mem['loss']):.6f} and "
          f"{float(m_res['loss']):.6f}, {len(diff)} parameters differ "
          f"{diff if diff else '(bit for bit)'}")
    check(float(m_mem["loss"]) == float(m_res["loss"]) and not diff,
          f"train checkpoint: a step from the restored state differs from "
          f"one from the state in memory: {diff}")


def phase_train() -> dict:
    """The training path on the card: f32 gradient parity, kernels against
    plain, at full width (llama3.2-3b, mamba2-370m, jamba-v0.1-52b cut to
    a few layers); 3 AdamW steps of full-width, full-depth llama3.2-3b
    and mamba2-370m, and one more mamba2-370m step profiled by kernel;
    the training script for five families at
    small_100m; the llama run's checkpoint. Returns the launches of the
    full runs and the training script's runs."""
    _train_parity("llama3.2-3b", TRAIN_PARITY_LAYERS, TRAIN_S)
    launches = {name: 0 for name in SOURCES}
    _add_counts(launches, _train_full(
        "llama3.2-3b", TRAIN_S,
        ("layers.0.norm1", "layers.27.ffn.w_down", "embed"),
        "plus the logits (0.5 GB each of logits and their gradient), remat "
        "checkpoints and one layer's activations (~1 GB) and AdamW's "
        "temporaries of the largest leaf (~3 x 1.6 GB): ~64 GB"))
    _train_parity("mamba2-370m", TRAIN_PARITY_LAYERS, MAMBA_TRAIN_S)
    _add_counts(launches, _train_full(
        "mamba2-370m", MAMBA_TRAIN_S,
        ("layers.0.norm1", "layers.0.mamba.A_log", "layers.47.mamba.w_xBC",
         "embed"),
        "plus the logits (0.4 GB each of logits and their gradient), remat "
        "checkpoints and one layer's activations (~0.2 GB): ~7 GB",
        profile=True))
    _train_parity("jamba-v0.1-52b", JAMBA_PARITY_LAYERS, MAMBA_TRAIN_S)
    ck = ROOT / "build" / "train" / "llama3.2-3b-100m.npz"
    counts, state = _train_script(ck)
    for name in SOURCES:
        launches[name] += counts[name]
    _train_checkpoint(ck, state)
    ck.unlink()
    del state
    _free_device_memory()
    return launches


# ---------------------------------------------------------------- phase 14

TP = 2
# the tp phase's request mix: the serve script's, 6 requests under
# --max-len 512 (prompts of 32-255 tokens, 4-23 output tokens)
TP_REQUESTS, TP_MAX_LEN = 6, 512
TP_KW = dict(n_slots=8, max_len=TP_MAX_LEN, block_size=64, quantum=32,
             seed=0, device="cuda")
# the f32 replay's depth: qwen-7b at full width, 4 of its 32 layers
TP_F32_LAYERS = 4
# the f32 replay's sampled hidden states, TP = 2 against tp = 1 (TF32
# off), each iteration's within this share of its largest magnitude: a
# rank's GEMMs are narrower, so cuBLAS may pick another kernel, with
# another summation order, for them (predicted: at most 1e-5)
TP_F32_HIDDEN_REL = 1e-5
# jamba-v0.1-52b's depth in the tp phase: one period of its 32 layers;
# its f32 replay: the first 5 (Mamba2 with a dense FFN and with the MoE,
# twice, then the attention layer)
JAMBA_TP_LAYERS = 8
JAMBA_F32_LAYERS = 5
INT8_PATH = ("paged_attention_int8", "chunked_prefill_attention", "rmsnorm")


class _Rebuilt:
    """A freed engine as ``_streams_agree`` reads it: its prompts, kept,
    and the engine itself, rebuilt from its seed by ``build`` only when a
    divergence needs its forward (``_top2``)."""

    def __init__(self, build, tokens: dict):
        self._build, self._eng, self.tokens = build, None, tokens

    def __getattr__(self, name):
        if self._eng is None:
            self._eng = self._build()
        return getattr(self._eng, name)


def _tp_requests():
    from repro_torch.launch import serve
    return serve.make_requests(np.random.default_rng(0), TP_REQUESTS,
                               TP_MAX_LEN)


@contextlib.contextmanager
def _hidden_states(out: list):
    """While open, every fused forward of this process (rank 0 of a TP
    engine, or a tp = 1 engine) appends its sampled rows' final hidden
    states (``_sampled_hidden``, replicated on every rank) to ``out``."""
    from repro_torch.models import transformer as T

    orig = T._sampled_hidden

    def kept(*a, **kw):
        xs = orig(*a, **kw)
        out.append(xs.float().cpu())
        return xs
    T._sampled_hidden = kept
    try:
        yield out
    finally:
        T._sampled_hidden = orig


@contextlib.contextmanager
def _routes(out: list):
    """While open, every MoE router call of this process (rank 0's, the
    router being replicated) appends ``(step, rids, expert ids [n, K],
    the top K + 1 router logits [n, K + 1])`` over its live tokens only
    (real prefill positions, active decode slots; a call with none is
    skipped), ``step`` the calling engine's executed plans so far and
    ``rids`` the request of each live token."""
    from repro_torch.engine.torch_backend import TorchEngine
    from repro_torch.models import moe

    route, step = moe._route, TorchEngine._step
    cur = {}

    def stepped(self, rows, bts_host, bts=None):
        cur.update(eng=self, rows=rows)
        return step(self, rows, bts_host, bts)

    def routed(p, x, cfg):
        gates, idx = route(p, x, cfg)
        B, S = x.shape[:2]
        rows, eng = cur["rows"], cur["eng"]
        if S == 1:                  # the decode sub-batch: row j is slot j
            live = torch.as_tensor(rows[8])[:, None]
            slots = torch.arange(B)[:, None]
        else:                       # prefill rows [P, L] of slots rows[1]
            live = (torch.arange(S)[None] < torch.as_tensor(rows[3])[:, None])
            slots = torch.as_tensor(rows[1])[:, None].expand(B, S)
        live = live.reshape(-1)
        if live.any():
            owner = {s: r for r, s in eng.slot_of.items()}
            rids = [owner[int(s)] for s in slots.reshape(-1)[live]]
            lg = torch.einsum("bsd,de->bse", x, p.router).float()
            top = torch.sort(lg.reshape(B * S, -1), dim=-1,
                             descending=True).values[:, :cfg.moe.top_k + 1]
            on = live.to(x.device)
            out.append((len(eng.iteration_log), rids,
                        idx.reshape(B * S, -1)[on].cpu(), top[on].cpu()))
        return gates, idx
    moe._route, TorchEngine._step = routed, stepped
    try:
        yield out
    finally:
        moe._route, TorchEngine._step = route, step


def _token_steps(rec) -> dict:
    """rid -> the index of the recorded plan that emitted each of its
    tokens (the prompt's last chunk, then each decode)."""
    steps, i = {}, 0
    for kind, *args in rec.events:
        if kind != "exec":
            continue
        pre, dec = args
        for rid, c, start in pre:
            if start + c >= rec.reqs[rid].prompt_len:
                steps.setdefault(rid, []).append(i)
        for rid in dec:
            steps.setdefault(rid, []).append(i)
        i += 1
    return steps


def _parting_steps(rec, got: dict, want: dict) -> dict:
    """rid -> the recorded plan that emitted the first token at which the
    two streams of the request differ, for each request whose streams
    differ."""
    steps = _token_steps(rec)
    out = {}
    for rid in sorted(want):
        a, b = got[rid], want[rid]
        if a != b:
            i = next((j for j in range(min(len(a), len(b)))
                      if a[j] != b[j]), min(len(a), len(b)))
            out[rid] = steps[rid][i]
    return out


def _routing_flips(what: str, ref: list, got: list,
                   parted: dict) -> dict:
    """rid -> the step at which two runs over the same plans first routed
    a live token of that request to other experts. Every routing
    difference is looked at: each must sit at a router near-tie in both
    runs (the token's K-th and (K+1)-th logits within ``NEAR_TIE_ULPS``
    bf16 ulps of each other in each), unless the request had already
    routed apart in an earlier router call, or its stream had parted at
    a token emitted before this step (``parted``, ``_parting_steps``):
    from there on the two runs feed that request other inputs. A flip
    moves only its own request's later layers and tokens."""
    check(len(ref) == len(got), f"{what}: {len(ref)} against {len(got)} "
          f"router calls")
    first = {}                      # rid -> (router call, step)
    seen = ties = after = 0
    for i, ((step, ra, a, ta), (_, rb, b, tb)) in enumerate(zip(ref, got)):
        check(ra == rb and a.shape == b.shape, f"{what}: router call {i} "
              f"routed other tokens ({len(ra)} against {len(rb)})")
        diff = (a.sort(-1).values != b.sort(-1).values).any(-1)
        k = a.shape[-1]
        for r in diff.nonzero()[:, 0].tolist():
            seen += 1
            rid = ra[r]
            if first.get(rid, (i, step))[0] < i \
                    or parted.get(rid, step) < step:
                after += 1
                continue
            gaps = []
            for t in (ta, tb):
                mag = float(t[r, k - 1].abs())
                ulp = 2.0 ** (np.floor(np.log2(max(mag, 1e-30))) - 7)
                gaps.append(float(t[r, k - 1] - t[r, k]) / ulp)
            print(f"[streams] {what}: router call {i} (step {step}) routes "
                  f"a live token of rid {rid} apart: experts "
                  f"{a[r].tolist()} against {b[r].tolist()}, the K-th and "
                  f"(K+1)-th logits {gaps[0]:.2f} / {gaps[1]:.2f} bf16 "
                  f"ulps apart")
            check(max(gaps) <= NEAR_TIE_ULPS, f"{what}: router call {i} "
                  f"routed a live token of rid {rid} apart and it is not a "
                  f"near-tie in both runs ({gaps[0]:.2f} / {gaps[1]:.2f} "
                  f"ulps)")
            ties += 1
            first.setdefault(rid, (i, step))
    print(f"[streams] {what}: {seen} live tokens routed apart in "
          f"{len(ref)} router calls: {ties} at near-ties in both runs, "
          f"{after} of requests that had routed or streamed apart before")
    return {rid: step for rid, (_, step) in first.items()}


def _moe_streams_agree(what: str, eng, rec, got: dict, want: dict,
                       flips: dict) -> int:
    """``_streams_agree`` for a MoE model in bf16: a request's stream may
    also part at a token emitted at or after the step at which one of
    its own tokens was routed apart at a near-tie (``flips``,
    ``_routing_flips``), after which the two runs mix other experts for
    it; every other divergence must be a logit near-tie. Returns the
    streams that parted."""
    late = []
    for rid, step in _parting_steps(rec, got, want).items():
        if rid in flips and step >= flips[rid]:
            print(f"[streams] {what}: rid {rid} parts at step {step}, "
                  f"after its own routing near-tie at step {flips[rid]}")
            late.append(rid)
    early = [rid for rid in want if rid not in late]
    return len(late) + _streams_agree(
        what, eng, {r: got[r] for r in early}, {r: want[r] for r in early})


def _tp_checks(what: str, cfg, stats: list, kernels: tuple) -> dict:
    """Every rank launched each kernel of ``kernels`` and no other, ran
    no plain version, and launched the attention kernels at its local
    head counts only; the MoE families took a capacity rung on every
    rank. Returns the launches summed over the ranks."""
    h, kv = cfg.num_heads // TP, cfg.num_kv_heads // TP
    total = {name: 0 for name in SOURCES}
    for rank, st in enumerate(stats):
        for name, c in st["counts"].items():
            check(c["plain"] == 0, f"{what} rank {rank}: the plain {name} "
                  f"ran {c['plain']} times")
            check((c["launches"] > 0) == (name in kernels),
                  f"{what} rank {rank}: {name} launched {c['launches']} "
                  f"times; this path's kernels are {kernels}")
            total[name] += c["launches"]
        for name, layouts in st["heads"].items():
            check(set(layouts) <= {(h, kv)}, f"{what} rank {rank}: {name} "
                  f"launched at head layouts {layouts}, not H{h} KV{kv}")
        if any(l.ffn == "moe" for l in cfg.layers):
            check(sum(st["rungs"].values()) > 0,
                  f"{what} rank {rank}: the grouped MoE took no rung")
    return total


def _tp_replay(what: str, cfg, rec, dtype, kernels: tuple,
               kv_quant: bool = False, hidden=None, routes=None) -> tuple:
    """``rec``'s plans replayed into ``TorchEngine(tp=TP)`` (standalone,
    its own pool) after its warm-up, the counters of every rank zeroed
    just before: each rank's kernels at its local head counts
    (``_tp_checks``), and the bytes the ranks' gathers received, summed,
    equal to ``TPServePlan.collective_bytes`` over the rows the gathers
    moved (prefill P x L tokens and every decode slot; the element size
    of ``dtype``). ``hidden`` and ``routes`` collect the sampled hidden
    states and the routing (``_hidden_states``, ``_routes``). Returns
    the streams, the launches, the seconds."""
    from repro_torch.distributed import TPServePlan
    from repro_torch.engine.torch_backend import TorchEngine

    t0 = time.perf_counter()
    eng = TorchEngine(cfg, dtype=dtype, kv_quant=kv_quant, tp=TP, **TP_KW)
    try:
        check(eng._tp_group.backend == "gloo", f"{what}: backend "
              f"{eng._tp_group.backend}, not gloo")
        built = time.perf_counter() - t0
        if any(l.ffn == "moe" for l in cfg.layers):
            e_loc = {l.moe.w_gate.shape[0] for l in eng.params.layers
                     if hasattr(l, "moe")}
            check(e_loc == {cfg.moe.num_experts // TP}, f"{what}: rank 0 "
                  f"holds {e_loc} experts a layer")
        eng.warm()
        eng.reset_rank_stats()
        moved = []
        with contextlib.ExitStack() as stack:
            if hidden is not None:
                stack.enter_context(_hidden_states(hidden))
            if routes is not None:
                stack.enter_context(_routes(routes))
            step = eng._step

            def counted(rows, bts_host, bts=None):
                (P, L), nd = rows[0].shape, rows[6].shape[0]
                moved.append((P * L + nd, P + nd))
                return step(rows, bts_host, bts)
            eng._step = counted
            secs = _replay(eng, rec)
        stats = eng.rank_stats()
        got = {rid: list(t) for rid, t in eng.generated.items()}
    finally:
        eng.close()
    launches = _tp_checks(what, cfg, stats, kernels)
    plan = TPServePlan(cfg, TP)
    el = torch.tensor([], dtype=dtype).element_size()
    want = {}
    for n, rows in moved:
        for op, b in plan.collective_bytes(n, rows, el).items():
            want[op] = want.get(op, 0.0) + b
    recv = {}
    for st in stats:
        for op, b in st["recv_bytes"].items():
            recv[op] = recv.get(op, 0) + b
    check(recv == want, f"{what}: the gathers received {recv} bytes, the "
          f"plan accounts {want}")
    mem = [round(st["peak_device_bytes"] / 1e9, 2) for st in stats]
    print(f"[tp] {what}: TP={TP} over {eng._tp_group.backend}, built in "
          f"{built:.1f} s, {len(moved)} steps replayed in {secs:.2f} s; "
          f"bytes received by the gathers {recv} = the plan's account; "
          f"launches by rank "
          f"{[{k: c['launches'] for k, c in st['counts'].items() if c['launches']} for st in stats]}"
          f" at heads {[st['heads'] for st in stats]}; peak device GB by "
          f"rank {mem}")
    del eng
    _free_device_memory()
    return got, launches, secs


def _tp_wall_numbers(rep) -> dict:
    """Served output tok/s over the replica's busy seconds, TTFT and TBT
    p50 / p99 from the requests' own timestamps (wall clock)."""
    from repro_torch.serving.metrics import compute_metrics

    reqs = rep.all_requests()
    m = compute_metrics(reqs, rep.now)
    tbts = [d for q in reqs for d in q.tbts()]
    n_tok = sum(len(rep.backend.generated[q.rid]) for q in reqs)
    return dict(tok_s=n_tok / rep.busy_time, ttft_p50=m.ttft_p50,
                ttft_p99=m.ttft_p99, tbt_p50=float(np.percentile(tbts, 50)),
                tbt_p99=m.tbt_p99, iterations=rep.iterations,
                busy_s=rep.busy_time, tokens=n_tok)


def _tp_qwen(launches: dict) -> None:
    """qwen-7b at full width and depth: the tp = 1 wall run records its
    plans; the bf16 replay into TP = 2 (near-ties logged), the f32
    replay at 4 layers (no near-tie; hidden states within
    ``TP_F32_HIDDEN_REL``), the int8 replay against a tp = 1 int8 replay
    of the same plans, then ``make_torch_replica(tp=2)`` on the wall
    clock beside the tp = 1 run."""
    import functools

    from repro_torch.engine.torch_backend import TorchEngine

    cfg = _model_config("qwen-7b")
    bf16, f32 = torch.bfloat16, torch.float32
    reqs = _tp_requests()
    rep1 = _replica("qwen-7b", "niyama", False, max_len=TP_MAX_LEN,
                    backend_wrap=functools.partial(_Recorder, wall=True))
    rec = rep1.backend
    rec.inner.warm()
    rep1.submit_all(reqs)
    rep1.run()
    torch.cuda.synchronize()
    check(len(rep1.finished) == len(reqs), f"tp qwen-7b tp=1: "
          f"{len(rep1.finished)}/{len(reqs)} requests finished")
    want = {rid: list(t) for rid, t in rec.inner.generated.items()}
    for r in reqs:
        check(len(want[r.rid]) == r.decode_len, f"tp qwen-7b tp=1: rid "
              f"{r.rid} streamed {len(want[r.rid])} of {r.decode_len}")
    wall1 = _tp_wall_numbers(rep1)
    tokens = dict(rec.inner.tokens)
    rec.inner = None
    del rep1
    _free_device_memory()

    def ref(dtype, kv_quant=False):
        return _Rebuilt(lambda: TorchEngine(cfg, dtype=dtype,
                                            kv_quant=kv_quant, **TP_KW),
                        tokens)

    got, n, _ = _tp_replay("qwen-7b bf16", cfg, rec, bf16, ATTENTION_PATH)
    _add(launches, n)
    ties = _streams_agree("qwen-7b TP=2 bf16 against tp=1", ref(bf16), got,
                          want)
    _free_device_memory()
    print(f"[tp] qwen-7b bf16: TP=2 streams agree with tp=1's, {ties} of "
          f"{len(want)} requests at a logged near-tie")

    cut = dataclasses.replace(cfg, num_layers=TP_F32_LAYERS,
                              layers=cfg.layers[:TP_F32_LAYERS])
    h1, h2 = [], []
    one = TorchEngine(cut, dtype=f32, **TP_KW)
    # one fused forward a step, as the TP = 2 engine runs it (graphs
    # engage at tp = 1 only), so that each step's hidden states are seen
    one._split = False
    one.warm()
    with _hidden_states(h1):
        _replay(one, rec)
    want32 = {rid: list(t) for rid, t in one.generated.items()}
    del one
    _free_device_memory()
    got32, n, _ = _tp_replay(f"qwen-7b f32 ({TP_F32_LAYERS} layers)", cut,
                             rec, f32, ATTENTION_PATH, hidden=h2)
    _add(launches, n)
    _streams_agree("qwen-7b TP=2 f32 against tp=1", None, got32, want32,
                   near_tie=False)
    rel = _hidden_rel("qwen-7b f32", h1, h2)
    bits = all(torch.equal(a, b) for a, b in zip(h2, h1))
    print(f"[tp] qwen-7b f32 at {TP_F32_LAYERS} of 32 layers, TF32 off: "
          f"TP=2 streams equal tp=1's (no near-tie allowed); sampled "
          f"hidden states of {len(h1)} steps within {rel:.3g} of their "
          f"largest magnitude (limit {TP_F32_HIDDEN_REL:g}); bit-equal: "
          f"{bits}")
    del h1, h2

    one = TorchEngine(cfg, dtype=bf16, kv_quant=True, **TP_KW)
    one.warm()
    _replay(one, rec)
    want8 = {rid: list(t) for rid, t in one.generated.items()}
    del one
    _free_device_memory()
    got8, n, _ = _tp_replay("qwen-7b int8 pages", cfg, rec, bf16, INT8_PATH,
                            kv_quant=True)
    _add(launches, n)
    ties8 = _streams_agree("qwen-7b TP=2 int8 against tp=1 int8",
                           ref(bf16, kv_quant=True), got8, want8)
    _free_device_memory()
    print(f"[tp] qwen-7b int8 pages: TP=2 streams agree with a tp=1 int8 "
          f"replay of the same plans, {ties8} at a logged near-tie")

    rep2 = _replica("qwen-7b", "niyama", False, tp=TP, max_len=TP_MAX_LEN)
    try:
        rep2.backend.warm()
        rep2.backend.reset_rank_stats()
        rep2.submit_all(_tp_requests())
        rep2.run()
        stats = rep2.backend.rank_stats()
    finally:
        rep2.backend.close()
    check(len(rep2.finished) == TP_REQUESTS, f"tp qwen-7b wall: "
          f"{len(rep2.finished)}/{TP_REQUESTS} requests finished")
    _add(launches, _tp_checks("qwen-7b wall", cfg, stats, ATTENTION_PATH))
    wall2 = _tp_wall_numbers(rep2)
    del rep2
    _free_device_memory()
    for tag, w in (("tp=1", wall1), (f"tp={TP}", wall2)):
        print(f"[tp] qwen-7b wall run {tag}: {w['tokens']} output tokens in "
              f"{w['iterations']} iterations, {w['busy_s']:.2f} s busy, "
              f"{w['tok_s']:.1f} output tok/s; TTFT p50/p99 "
              f"{w['ttft_p50']:.3f}/{w['ttft_p99']:.3f} s; TBT p50/p99 "
              f"{w['tbt_p50'] * 1e3:.1f}/{w['tbt_p99'] * 1e3:.1f} ms")
    print(f"[tp] summary {json.dumps(dict(wall_tp1=wall1, wall_tp2=wall2))}")


def _add(total: dict, counts: dict) -> None:
    for name in total:
        total[name] += counts[name]


def _tp_cli(launches: dict) -> None:
    """``python -m repro_torch.launch.serve --tp 2`` as a user runs it,
    in this process (rank 0; the command spawns rank 1): full-width
    llama3.2-3b, 8 requests. It must print ``tp=2``, finish every
    request, and rank 0 must launch the attention kernels at H12 KV4
    only, and no plain version."""
    import io

    from repro_torch.kernels import ops
    from repro_torch.launch import serve

    buf = io.StringIO()
    with _counts_after_warm(), contextlib.redirect_stdout(buf):
        rep = serve.main(["--tp", str(TP), "--dtype", "bf16",
                          "--n-requests", str(TP_REQUESTS), "--max-len",
                          str(TP_MAX_LEN), "--slots", "8", "--seed", "0"])
    text = buf.getvalue()
    print(text.rstrip())
    check(f"tp={TP}" in text, "serve --tp: the summary does not say tp=2")
    check(len(rep.finished) == TP_REQUESTS, f"serve --tp: "
          f"{len(rep.finished)}/{TP_REQUESTS} requests finished")
    counts = ops.counts()
    _add(launches, {k: c["launches"] for k, c in counts.items()})
    _tp_checks("serve --tp 2 (rank 0)", rep.backend.cfg,
               [{"counts": counts, "heads": ops.heads(), "rungs": {}}],
               ATTENTION_PATH)
    del rep
    _free_device_memory()


def _tp_jamba(launches: dict) -> None:
    """jamba-v0.1-52b at full widths, cut to its first period of 8
    layers (an attention layer, seven Mamba2 layers, the 16-expert MoE
    on every other one): a tp = 1 fixed-clock run records its plans and
    routing, that engine is freed, and the plans replay into TP = 2
    (attention at H16 KV4, 8 local experts a rank, the scan on both
    ranks). In bf16 a rounding difference can flip a router near-tie
    (top-2 of 16 over bf16 logits), after which the two runs mix other
    experts for that request: ``_routing_flips`` holds every routing
    difference to a near-tie in both runs, unless its request had
    already routed or streamed apart, and ``_moe_streams_agree`` lets a
    request's stream part only after its own flip. Then the same
    plans at 5 of its layers in f32, TF32 off: equal streams (no near-tie
    allowed), no token routed apart, and sampled hidden states within
    ``TP_F32_HIDDEN_REL``."""
    from repro_torch.engine.torch_backend import TorchEngine

    full = _model_config("jamba-v0.1-52b")
    cut = dataclasses.replace(full, num_layers=JAMBA_TP_LAYERS,
                              layers=full.layers[:JAMBA_TP_LAYERS])
    kw = dict(n_slots=8, max_len=TP_MAX_LEN, seed=0, dtype=torch.bfloat16,
              device=TP_KW["device"])
    r1, r2 = [], []
    with _routes(r1):
        rec, want, secs, _ = _recorded_fused_run(cut, _tp_requests(), kw)
    tokens = dict(rec.inner.tokens)
    rec.inner = None
    _free_device_memory()
    print(f"[tp] jamba-v0.1-52b ({JAMBA_TP_LAYERS} of 32 layers): tp=1 "
          f"served {len(want)} requests in {secs:.2f} s")
    got, n, _ = _tp_replay(f"jamba-v0.1-52b ({JAMBA_TP_LAYERS} layers) "
                           f"bf16", cut, rec, torch.bfloat16,
                           ATTENTION_PATH + ("ssd_scan",), routes=r2)
    _add(launches, n)
    what = "jamba TP=2 bf16 against tp=1"
    flips = _routing_flips(what, r1, r2, _parting_steps(rec, got, want))
    parted = _moe_streams_agree(
        what, _Rebuilt(lambda: TorchEngine(cut, quantum=32, block_size=64,
                                           **kw), tokens),
        rec, got, want, flips)
    _free_device_memory()
    print(f"[tp] jamba-v0.1-52b bf16: TP=2 streams agree with tp=1's; "
          f"{parted} of {len(want)} parted, each after a logged near-tie "
          f"(its own routing near-ties at steps {flips})")

    cut5 = dataclasses.replace(full, num_layers=JAMBA_F32_LAYERS,
                               layers=full.layers[:JAMBA_F32_LAYERS])
    h1, h2, r1, r2 = [], [], [], []
    one = TorchEngine(cut5, dtype=torch.float32, **TP_KW)
    one.warm()
    with _hidden_states(h1), _routes(r1):
        _replay(one, rec)
    want32 = {rid: list(t) for rid, t in one.generated.items()}
    del one
    _free_device_memory()
    got32, n, _ = _tp_replay(f"jamba-v0.1-52b f32 ({JAMBA_F32_LAYERS} "
                             f"layers)", cut5, rec, torch.float32,
                             ATTENTION_PATH + ("ssd_scan",), hidden=h2,
                             routes=r2)
    _add(launches, n)
    check(not _routing_flips("jamba TP=2 f32 against tp=1", r1, r2, {}),
          "jamba f32: a live token was routed apart")
    _streams_agree("jamba TP=2 f32 against tp=1", None, got32, want32,
                   near_tie=False)
    rel = _hidden_rel("jamba f32", h1, h2)
    print(f"[tp] jamba-v0.1-52b f32 at {JAMBA_F32_LAYERS} of 32 layers, "
          f"TF32 off: TP=2 streams equal tp=1's (no near-tie allowed), "
          f"{len(r1)} router calls routed alike, sampled hidden states "
          f"within {rel:.3g} of their largest magnitude; bit-equal: "
          f"{all(torch.equal(a, b) for a, b in zip(h1, h2))}")


def _hidden_rel(what: str, ref: list, got: list) -> float:
    """The largest difference of two runs' sampled hidden states, step by
    step, as a share of the step's largest magnitude; fails above
    ``TP_F32_HIDDEN_REL``."""
    check(len(ref) == len(got), f"{what}: {len(ref)} against {len(got)} "
          f"steps")
    rel = max(float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
              for a, b in zip(got, ref))
    check(rel <= TP_F32_HIDDEN_REL, f"{what}: sampled hidden states differ "
          f"by {rel:.3g} of their largest magnitude (limit "
          f"{TP_F32_HIDDEN_REL:g})")
    return rel


def phase_tp() -> dict:
    """Tensor-parallel serve at TP = 2 on one card: two processes, each
    rank holding its shard, joined over gloo (NCCL refuses two ranks on
    one device). qwen-7b (``_tp_qwen``), the serve script with ``--tp 2``
    (``_tp_cli``) and jamba-v0.1-52b cut to 8 layers (``_tp_jamba``).
    Each engine and its ranks are stopped and freed before the next.
    Returns the launches of every rank in the phase's runs."""
    launches = {name: 0 for name in SOURCES}
    _tp_qwen(launches)
    _tp_cli(launches)
    _tp_jamba(launches)
    print(f"[tp] launches of the phase's runs, every rank's, each at its "
          f"rank's local head counts: "
          f"{ {k: n for k, n in launches.items() if n} }")
    return launches


# the sharding phase: the host-mesh serve steps on full-width llama3.2-3b
# in bf16 (SHARD_B prompts of SHARD_S tokens, one decode step), the
# host-mesh train step at SHARD_TRAIN_LAYERS of 28 layers in f32, and the
# dry-run of one pair in a subprocess given SHARD_DRYRUN_S seconds
SHARD_B, SHARD_S = 4, 512
SHARD_TRAIN_LAYERS = 4
SHARD_DRYRUN_S = 60
SHARD_DRYRUN = ("llama3.2-3b", "decode_32k")


def _host_serve(params, cfg, tokens, shard) -> tuple:
    """One prefill of ``tokens`` and one greedy decode step through the
    offline steps (``shard`` given, or the steps' default)."""
    from repro_torch.engine.steps import (make_prefill_step,
                                          make_serve_step, sample_greedy)
    from repro_torch.models.transformer import init_cache
    kw = {} if shard is None else {"shard": shard}
    cache = init_cache(cfg, tokens.shape[0], tokens.shape[1] + 8,
                       dtype=torch.bfloat16, device="cuda")
    lg, cache = make_prefill_step(cfg, **kw)(params, cache,
                                             {"tokens": tokens})
    nxt = sample_greedy(lg, cfg.vocab_size)
    lg2, _ = make_serve_step(cfg, **kw)(params, cache, nxt)
    torch.cuda.synchronize()
    return lg, lg2


def _host_train(cfg, batch, rules) -> tuple:
    """One AdamW step from seed-0 weights: with ``rules`` through
    ``shard=`` and ``grad_shardings=``, else unsharded. Returns the
    metrics, the parameters and the first moments (the clipped
    gradients times 1 - b1)."""
    from repro_torch.distributed.sharding import placements
    from repro_torch.engine.steps import init_train_state, make_train_step
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    params, opt = init_train_state(cfg, gen, device="cuda")
    if rules is None:
        step = make_train_step(cfg, lr=1e-3)
    else:
        pls = {n: placements(spec, rules.mesh) for n, spec in
               rules.param_specs(params).items()}
        step = make_train_step(cfg, shard=rules.shard_fn(), lr=1e-3,
                               grad_shardings=pls)
    params, opt, m = step(params, opt, batch)
    torch.cuda.synchronize()
    return m, dict(params.named_parameters()), opt.mu


def _dryrun_on_the_card_machine() -> dict:
    """``run_one`` of ``SHARD_DRYRUN`` on the 16x16 fake mesh, in a
    subprocess of its own (the fake group is process-global), within
    ``SHARD_DRYRUN_S`` seconds; nothing is saved."""
    arch, shape = SHARD_DRYRUN
    code = ("import json, sys; from repro_torch.launch.dryrun import "
            "run_one; from repro_torch.distributed.torch_api import "
            "describe; r = run_one(sys.argv[1], sys.argv[2], False, "
            "save=False); r['api'] = describe(); "
            "print('REPORT ' + json.dumps(r))")
    t = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", code, arch, shape],
                          capture_output=True, text=True,
                          timeout=SHARD_DRYRUN_S, cwd=ROOT,
                          env={**__import__("os").environ,
                               "PYTHONPATH": str(ROOT / "src")})
    secs = time.perf_counter() - t
    check(proc.returncode == 0, f"sharding dry-run: exit "
          f"{proc.returncode}: {proc.stderr[-2000:]}")
    line = [l for l in proc.stdout.splitlines() if l.startswith("REPORT ")]
    check(bool(line), "sharding dry-run: no report")
    rep = json.loads(line[-1][len("REPORT "):])
    check(rep.get("ok") is True, f"sharding dry-run: {rep.get('error')}")
    print(f"[sharding] dry-run {arch} x {shape} on the 16x16 fake mesh "
          f"({rep['api']}), {secs:.1f} s in a subprocess: t_compute "
          f"{rep['t_compute_s']:.3e} s, t_memory {rep['t_memory_s']:.3e} "
          f"s, t_collective {rep['t_collective_s']:.3e} s, dominant "
          f"{rep['dominant']}, peak {rep['peak_bytes_per_dev'] / 1e9:.3f} "
          f"GB per device (datasheet constants over a trace on meta "
          f"tensors, not measured times)")
    return rep


def phase_sharding() -> dict:
    """The sharding layer on the card: (a) the host-mesh prefill and
    serve steps (``make_host_mesh("cuda")``, ``shard=rules.shard_fn()``)
    of full-width llama3.2-3b in bf16 against the unsharded steps, logits
    bit-equal, the norm kernel launched and no plain version run; (b) one
    host-mesh AdamW step (``shard=`` and ``grad_shardings=``) at
    ``SHARD_TRAIN_LAYERS`` of 28 full-width layers in f32, TF32 off,
    against the unsharded step: loss, first moments and parameters
    bit-equal, the norm's forward and backward kernels counted; (c) the
    dry-run of ``SHARD_DRYRUN`` in a subprocess. Returns the launches of
    (a)'s and (b)'s sharded runs."""
    from repro_torch.distributed import torch_api as ta
    from repro_torch.distributed.sharding import ShardingRules
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.train import synthetic_batch
    from repro_torch.models.transformer import init_params

    launches = {name: 0 for name in SOURCES}
    print(f"[sharding] {ta.describe()}")
    mesh = make_host_mesh("cuda")
    try:
        cfg = _model_config("llama3.2-3b")
        gen = torch.Generator(device="cuda")
        gen.manual_seed(0)
        params = init_params(cfg, gen, "cuda", torch.bfloat16)
        tokens = torch.randint(0, cfg.vocab_size, (SHARD_B, SHARD_S),
                               generator=gen, device="cuda",
                               dtype=torch.int32)
        rules = ShardingRules(cfg, mesh, train=False)
        ops.reset_counts()
        got = _host_serve(params, cfg, tokens, rules.shard_fn())
        counts = _path_counts("sharding host-mesh serve", ("rmsnorm",))
        _add_counts(launches, counts)
        want = _host_serve(params, cfg, tokens, None)
        for what, a, b in zip(("prefill", "decode"), got, want):
            check(torch.equal(a, b), f"sharding host-mesh {what}: logits "
                  f"differ from the unsharded step's by "
                  f"{float((a.float() - b.float()).abs().max()):.3g}")
        print(f"[sharding] (a) host-mesh prefill + decode, llama3.2-3b "
              f"full width bf16, {SHARD_B} x {SHARD_S} tokens: logits "
              f"bit-equal to the unsharded steps'; rmsnorm launched "
              f"{counts['rmsnorm']['launches']} times, no plain version")
        del params, got, want
        _free_device_memory()

        cut = dataclasses.replace(cfg, num_layers=SHARD_TRAIN_LAYERS,
                                  layers=cfg.layers[:SHARD_TRAIN_LAYERS])
        batch = synthetic_batch(np.random.default_rng(0), cut, TRAIN_B,
                                TRAIN_S, "cuda")
        trules = ShardingRules(cut, mesh, train=True)
        ops.reset_counts()
        m1, p1, mu1 = _host_train(cut, batch, trules)
        counts = _path_counts("sharding host-mesh train", TRAIN_PATH)
        _add_counts(launches, counts)
        predicted = _predicted_launches(cut, 1)
        for k in TRAIN_PATH:
            check(counts[k]["launches"] == predicted[k],
                  f"sharding host-mesh train: {k} launched "
                  f"{counts[k]['launches']} times, {predicted[k]} predicted")
        m2, p2, mu2 = _host_train(cut, batch, None)
        check(torch.equal(m1["loss"], m2["loss"])
              and torch.equal(m1["grad_norm"], m2["grad_norm"]),
              f"sharding host-mesh train: loss {float(m1['loss'])} against "
              f"{float(m2['loss'])}")
        for n in p2:
            check(torch.equal(p1[n], p2[n]) and torch.equal(mu1[n], mu2[n]),
                  f"sharding host-mesh train: {n} differs")
        print(f"[sharding] (b) host-mesh AdamW step, llama3.2-3b "
              f"{SHARD_TRAIN_LAYERS} of 28 layers full width f32, batch "
              f"{TRAIN_B} x {TRAIN_S}: loss {float(m1['loss']):.6f}, "
              f"gradients (first moments) and parameters bit-equal to the "
              f"unsharded step's; rmsnorm {counts['rmsnorm']['launches']}, "
              f"rmsnorm_bwd {counts['rmsnorm_bwd']['launches']} launches "
              f"(as predicted), no plain version")
        del p1, p2, mu1, mu2
        _free_device_memory()
    finally:
        ta.destroy_group()
    _dryrun_on_the_card_machine()
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {__file__}; run it "
              f"from a checkout of the repository", file=sys.stderr)
        return 2
    # the card's name and power limit, as nvidia-smi prints them
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")
    # f32 comparisons run in full f32: no TF32 in matmuls or convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()

    phases = []

    def timed(name, fn, *args, **kw):
        """Run one phase; print its seconds and its peak device memory."""
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        out = fn(*args, **kw)
        peak = torch.cuda.max_memory_allocated() / 1e9
        secs = time.perf_counter() - t
        phases.append(f"{name} {secs:.1f} s / {peak:.2f} GB")
        print(f"[time] {name}: {secs:.1f} s, peak device memory "
              f"{peak:.2f} GB allocated")
        return out
    timed("build", phase_build)
    head = timed("kernels", phase_kernels)
    # each served path: counts zeroed just before it, read just after;
    # its engine profiled, then freed before the next model is built
    launches = {name: 0 for name in SOURCES}
    for path, p in PATHS.items():
        counts, eng = timed(f"serve {path}", phase_serve, path)
        for name in SOURCES:
            launches[name] += counts[name]["launches"]
        timed(f"profile {path}", phase_profile, eng, prefill=not p.kv_quant,
              at=p.profile_at)
        del eng
        _free_device_memory()
    timed("parity llama3.2-3b", phase_parity, "llama3.2-3b")
    timed("parity mamba2-370m", phase_parity_mamba)
    timed("parity llama3.2-3b int8", phase_parity, "llama3.2-3b int8")
    timed("parity qwen3-moe-30b-a3b", phase_parity, "qwen3-moe-30b-a3b")
    timed("parity gemma3-4b", phase_parity, "gemma3-4b")
    timed("hierarchy bf16", phase_hierarchy, kv_quant=False)
    timed("hierarchy int8", phase_hierarchy, kv_quant=True)
    timed("reclaim", phase_reclaim)
    # the fleet: each two-engine run's counts zeroed just before it and
    # read just after, before its single-engine reference runs
    counts = timed("fleet", phase_fleet)
    for name in SOURCES:
        launches[name] += counts[name]["launches"]
    # the reference engine, whisper-medium, internvl2-76b and the obs
    # phase: each run's counts zeroed just before it and read just after
    for name, fn, *args in (("reference llama3.2-3b", phase_reference,
                             "llama3.2-3b"),
                            ("reference mamba2-370m", phase_reference,
                             "mamba2-370m"),
                            ("whisper-medium", phase_whisper),
                            (f"internvl2-76b ({INTERNVL_LAYERS} of 80 "
                             f"layers)", phase_internvl2),
                            ("obs llama3.2-3b", phase_obs),
                            ("train", phase_train),
                            (f"tp (TP={TP})", phase_tp),
                            ("sharding", phase_sharding)):
        for kernel, n in timed(name, fn, *args).items():
            launches[kernel] += n
    kernels = []
    for name, (src, replaces) in SOURCES.items():
        kernels.append(dict(name=name, route="cuda", source=src,
                            replaces=replaces, launches=launches[name],
                            **head[name]))
        print(f"[kernels] {name}: ported (cuda, {src}), agrees with its "
              f"plain version in f32 and bf16, launched {launches[name]} "
              f"times on the served and trained paths")
    print(f"[done] {time.perf_counter() - t0:.1f} s on {card}; each phase's "
          f"seconds and peak device memory: {'; '.join(phases)}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
