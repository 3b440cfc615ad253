"""The serve script of the port: the Niyama stack end to end on PyTorch.

The counterpart of the JAX package's ``launch/serve.py``, with its three
entry points:

  --backend torch   real forward passes through ``TorchEngine`` or
                    ``ReferenceTorchEngine`` (the counterpart of
                    ``--backend jax``; the default)
  --backend sim     the calibrated A100 oracle on the paper's datasets
                    (``--dataset``, ``--qps``, ``--duration``; paper-scale
                    studies, no device)
  --fleet N         N >= 2 real engines on worker threads behind the
                    asyncio streaming front-end, with live cross-replica
                    KV transfer (``make_async_torch_fleet``)

The torch backend serves the JAX serve script's request mix through the
same scheduler and replica, built by ``make_torch_replica``. On the card
(the default) it serves the full configuration with the NiyamaScheduler
priced on the ``H100`` spec; ``--reduced`` gives the JAX serve script's
``.reduced(num_layers=2, d_model=256)`` model, for CPU runs. ``--arch``
picks the architecture from the port's registry (``repro_torch.configs``):
``llama3.2-3b`` (the default), ``mamba2-370m``, the MoE decoders
``qwen3-moe-30b-a3b`` and ``dbrx-132b``, the hybrid ``jamba-v0.1-52b``,
``granite-8b``, ``starcoder2-15b`` or the sliding-window decoder
``gemma3-4b``, the vision-language ``internvl2-76b`` or the
encoder-decoder ``whisper-medium``. ``--engine`` picks the fused engine
(the default) or the slot-sequential reference oracle, the only one
that serves ``whisper-medium`` (the fused engine refuses it, as JAX's
does); ``--kv-layout`` picks the fused engine's paged pool (the
default) or its dense slot cache. ``--prefix-cache`` gives the replica
the KV hierarchy's shared-prefix tier (paged fused engine only), as in
the JAX serve script. ``--tp N`` serves the fused engine over N
tensor-parallel ranks (``TorchEngine(tp=N)``): the command spawns the
other ranks itself, over gloo on the CPU or on one shared card, and
stops them when it is done. ``--trace-out`` and ``--trace-chrome`` record the
request-lifecycle trace (``repro_torch.obs``) on any of the three
paths, write it as JSONL or Chrome trace events and print the
SLO-violation attribution table; ``--metrics-port`` serves the fleet's
live metrics registry on ``GET /metrics`` with ``--fleet``.

  PYTHONPATH=src python -m repro_torch.launch.serve --dtype bf16 \
      --n-requests 12 --max-len 2048
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-370m \
      --dtype bf16 --n-requests 12 --max-len 2048
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --reduced
  PYTHONPATH=src python -m repro_torch.launch.serve --dtype bf16 --tp 2 \
      --n-requests 12 --max-len 2048
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --reduced \
      --tp 2
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --reduced \
      --arch qwen3-moe-30b-a3b
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --reduced \
      --engine reference
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --reduced \
      --kv-layout dense
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --reduced \
      --arch whisper-medium --engine reference
  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-4b \
      --dtype bf16 --n-requests 12 --max-len 2048
  PYTHONPATH=src python -m repro_torch.launch.serve --backend sim \
      --dataset azure_code --qps 2 --duration 120
  PYTHONPATH=src python -m repro_torch.launch.serve --fleet 2 --dtype bf16 \
      --n-requests 12 --slots 4 --max-len 2048
  PYTHONPATH=src python -m repro_torch.launch.serve --fleet 2 --device cpu \
      --reduced --n-requests 8 --slots 2 --max-len 128
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --reduced \
      --trace-out trace.jsonl --trace-chrome trace.json
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.predictor import A100, H100
from repro_torch.core.qos import PAPER_TIERS
from repro_torch.core.request import Request
from repro_torch.data import workloads
from repro_torch.device import resolve_device
from repro_torch.serving.kvcache import KVCacheConfig
from repro_torch.serving.metrics import compute_metrics
from repro_torch.serving.schemes import (CPU_HW, CPU_TIERS,
                                         make_async_torch_fleet, make_replica,
                                         make_torch_replica)

DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def _make_recorder(args):
    """A TraceRecorder when either trace flag asks for one, else None
    (the stack's hooks stay inert without it)."""
    if args.trace_out is None and args.trace_chrome is None:
        return None
    from repro_torch.obs import TraceRecorder
    return TraceRecorder()


def _finish_trace(args, rec, requests) -> None:
    """Export the recorded trace and print the attribution table."""
    if rec is None:
        return
    from repro_torch.obs import attribute, render_attribution_table
    if args.trace_out:
        n = rec.export_jsonl(args.trace_out)
        print(f"  trace: {n} events -> {args.trace_out}"
              + (f" ({rec.dropped} dropped)" if rec.dropped else ""))
    if args.trace_chrome:
        rec.export_chrome(args.trace_chrome)
        print(f"  chrome trace -> {args.trace_chrome} "
              f"(open in chrome://tracing or ui.perfetto.dev)")
    print(render_attribution_table(attribute(rec, list(requests))))


def make_requests(rng: np.random.Generator, n: int, max_len: int):
    """The JAX serve script's request mix: arrivals spread over ``n``
    seconds, prompts of 32 .. max_len/2 tokens, 4 .. 23 output tokens,
    the three tiers in turn, every fifth request unimportant."""
    reqs = []
    arr = np.sort(rng.uniform(0, n * 1.0, n))
    for i, t in enumerate(arr):
        q = CPU_TIERS[i % 3]
        reqs.append(Request(
            rid=i, arrival=float(t),
            prompt_len=int(rng.integers(32, max_len // 2)),
            decode_len=int(rng.integers(4, 24)), qos=q,
            app_id=q.name, important=bool(i % 5)))
    return reqs


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-3b",
                    help="an architecture of repro_torch.configs")
    ap.add_argument("--scheme", default="niyama")
    ap.add_argument("--backend", choices=["torch", "sim"], default="torch",
                    help="torch: real forward passes through TorchEngine; "
                         "sim: the calibrated A100 oracle on --dataset")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", choices=sorted(DTYPES), default="f32",
                    help="weights and KV pages; bf16 is the serving type "
                         "on the card")
    ap.add_argument("--reduced", action="store_true",
                    help="serve .reduced(num_layers=2, d_model=256)")
    ap.add_argument("--engine", choices=["fused", "reference"],
                    default="fused",
                    help="torch backend engine: fused one-forward "
                         "continuous batching, or the slot-sequential "
                         "reference oracle")
    ap.add_argument("--kv-layout", choices=["paged", "dense"],
                    default="paged",
                    help="fused-engine KV layout: block-paged pool "
                         "(default) or the contiguous per-slot cache")
    ap.add_argument("--block-size", type=int, default=64,
                    help="tokens per KV block")
    ap.add_argument("--kv-blocks", type=int, default=None,
                    help="physical blocks in the pool (default: enough "
                         "for every slot at max-len)")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="enable the shared-prefix KV cache tier on the "
                         "engine's pages")
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel degree of the fused engine: "
                         "heads, d_ff, experts and vocab shard over this "
                         "many ranks, spawned by this command (gloo on "
                         "the CPU or on one shared card, NCCL over a "
                         "card per rank)")
    ap.add_argument("--dataset", default="azure_code",
                    help="sim backend: one of data.workloads.DATASETS")
    ap.add_argument("--qps", type=float, default=2.0)
    ap.add_argument("--duration", type=float, default=120.0)
    ap.add_argument("--n-requests", type=int, default=12)
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--fleet", type=int, default=0,
                    help="torch backend: serve through the async fleet "
                         "runtime with this many real engines (>= 2) "
                         "behind the streaming front-end; 0 keeps the "
                         "single-replica batch driver")
    ap.add_argument("--tick", type=float, default=0.1,
                    help="async fleet: seconds between soft barriers "
                         "(the global offload/migration decision passes)")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="record the request-lifecycle trace and write "
                         "it as JSONL (docs/observability.md §Span "
                         "schema); also prints the SLO-violation "
                         "attribution table at exit")
    ap.add_argument("--trace-chrome", default=None, metavar="PATH",
                    help="also export the trace as Chrome trace_event "
                         "JSON (load in chrome://tracing or perfetto)")
    ap.add_argument("--metrics-port", type=int, default=None,
                    help="with --fleet: serve the live metrics registry "
                         "as Prometheus text on GET /metrics at this "
                         "port (0 picks a free one)")
    args = ap.parse_args(argv)

    rng = np.random.default_rng(args.seed)
    if args.fleet >= 2:
        if args.backend != "torch":
            ap.error("--fleet needs --backend torch (real engines)")
        return _serve_fleet(args, rng)
    rec = _make_recorder(args)
    if args.backend == "sim":
        return _serve_sim(args, rng, rec)
    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced(num_layers=2, d_model=256)
    rep = make_torch_replica(
        args.scheme, cfg, engine=args.engine, kv_layout=args.kv_layout,
        n_slots=args.slots, max_len=args.max_len,
        block_size=args.block_size, kv_blocks=args.kv_blocks,
        seed=args.seed, hw=H100 if device.type == "cuda" else CPU_HW,
        device=device, dtype=DTYPES[args.dtype],
        kv_cfg=(KVCacheConfig(enable_prefix=True) if args.prefix_cache
                else None), tp=args.tp)
    rep.tracer = rec
    reqs = make_requests(rng, args.n_requests, args.max_len)
    try:
        # build and load the kernels and run one iteration at the model's
        # shapes before the clock starts, so no request pays for the set-up
        rep.backend.warm()
        # arrivals in virtual time; each iteration advances it by its
        # measured wall-clock time
        rep.submit_all(reqs)
        rep.run()
    finally:
        if args.tp > 1:
            rep.backend.close()
    dur = rep.now

    tp_tag = f" tp={args.tp}" if args.tp > 1 else ""
    print(f"\nscheme={args.scheme} engine={args.engine} "
          f"kv_layout={args.kv_layout} device={device} dtype={args.dtype} "
          f"arch={cfg.name} layers={cfg.num_layers} d_model={cfg.d_model}"
          f"{tp_tag}")
    _report(rep, dur)
    print(f"  kv pool: {rep.kv.num_blocks} blocks x {rep.kv.block_size} "
          f"tokens, util {rep.kv.utilization():.0%} at exit")
    some = {k: v[:8] for k, v in list(rep.backend.generated.items())[:3]}
    print(f"  sample generations (token ids): {some}")
    _finish_trace(args, rec, rep.all_requests())
    return rep


def _serve_sim(args, rng, rec):
    """``--backend sim``: the JAX serve script's simulator path, the full
    configuration priced on the A100 spec, Poisson arrivals of the
    paper's ``--dataset`` at ``--qps`` for ``--duration`` seconds, the
    paper's tiers."""
    cfg = get_config(args.arch)
    rep = make_replica(args.scheme, cfg, A100, seed=args.seed)
    rep.tracer = rec
    ds = workloads.DATASETS[args.dataset]
    arr = workloads.poisson_arrivals(rng, args.qps, args.duration)
    reqs = workloads.make_requests(ds, arr, rng, tiers=PAPER_TIERS)
    rep.submit_all(reqs)
    rep.run(until=args.duration * 10)
    print(f"\nscheme={args.scheme} backend=sim arch={cfg.name}")
    _report(rep, args.duration)
    _finish_trace(args, rec, rep.all_requests())
    return rep


def _report(rep, dur: float) -> None:
    """The JAX serve script's report lines over ``rep``'s requests, with
    ``dur`` seconds as the rate's denominator."""
    m = compute_metrics(rep.all_requests(), dur)
    print(f"  served {len(rep.finished)}/{m.n} requests in {dur:.1f}s "
          f"({rep.iterations} iterations)")
    print(f"  TTFT p50/p99: {m.ttft_p50:.2f}/{m.ttft_p99:.2f}s  "
          f"TBT p99: {m.tbt_p99*1e3:.0f}ms")
    print(f"  SLO violations: {m.violation_frac:.1%} "
          f"(by tier: {m.violation_by_tier})")
    print(f"  goodput: {m.goodput:.2f} req/s  "
          f"throughput: {m.throughput_tok:.1f} tok/s  "
          f"relegated: {m.relegated_frac:.1%}")


async def stream_all(srv, fleet, reqs):
    """Stream ``reqs`` through the running ``AsyncServer`` ``srv`` over
    the wall-clock ``fleet``: each request is submitted at a tenth of its
    arrival time (seconds after the start) and its tokens are consumed as
    they come. Returns the start and end times on the fleet's clock and
    ``[(rid, submit time, [TokenEvent, ...]), ...]`` in the order of
    ``reqs``."""
    import asyncio

    t0 = fleet.clock.now()

    async def one(req, delay):
        await asyncio.sleep(delay)
        t_sub = fleet.clock.now()
        evs = [ev async for ev in srv.stream(req, timeout=600.0)]
        return req.rid, t_sub, evs

    res = await asyncio.gather(*(one(r, 0.1 * r.arrival) for r in reqs))
    return t0, fleet.clock.now(), res


def stream_requests(fleet, reqs, metrics_port=None):
    """``stream_all`` behind an ``AsyncServer`` of its own, which with
    ``metrics_port`` also serves ``GET /metrics`` there (0 picks a free
    port). Returns the wall seconds from the start to the last token, the
    streams and the server's ``wall_metrics()``. Starts and stops the
    fleet."""
    import asyncio

    from repro_torch.serving.asyncfleet import AsyncServer

    async def run():
        async with AsyncServer(fleet, metrics_port=metrics_port) as srv:
            if srv.metrics_addr is not None:
                print(f"metrics: http://{srv.metrics_addr[0]}:"
                      f"{srv.metrics_addr[1]}/metrics")
            t0, t1, res = await stream_all(srv, fleet, reqs)
            return t0, t1, res, srv.wall_metrics()

    t0, t1, res, wall = asyncio.run(run())
    return max(t1 - t0, 1e-9), res, wall


def _serve_fleet(args, rng):
    """``--fleet N``: N real ``TorchEngine``s behind the async streaming
    front-end, as the JAX serve script's ``--fleet``. Requests are
    submitted over wall time (arrival spacing compressed 10x) and
    consumed token by token; latencies come from the per-token stream
    timestamps, not post-hoc request fields. Every engine builds and
    loads the kernels and runs one iteration on this thread before the
    workers start (``TorchEngine.warm``)."""
    from repro_torch.serving.asyncfleet.server import _pct

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced(num_layers=2, d_model=256)
    fleet = make_async_torch_fleet(
        cfg, args.fleet, scheme=args.scheme, n_slots=args.slots,
        max_len=args.max_len, block_size=args.block_size,
        kv_blocks=args.kv_blocks, seed=args.seed,
        hw=H100 if device.type == "cuda" else CPU_HW, device=device,
        dtype=DTYPES[args.dtype], tick=args.tick)
    for rep in fleet.replicas:
        fleet.engine_of(rep).warm()
    rec = _make_recorder(args)
    if rec is not None:
        from repro_torch.obs import install_tracer
        install_tracer(fleet, rec)
    reqs = make_requests(rng, args.n_requests, args.max_len)
    try:
        elapsed, res, wall = stream_requests(
            fleet, reqs, metrics_port=args.metrics_port)
    finally:
        fleet.close()
    ttfts = sorted(evs[0].t - t_sub for _, t_sub, evs in res if evs)
    tbts = sorted(b.t - a.t for _, _, evs in res
                  for a, b in zip(evs, evs[1:]))
    n_tok = sum(len(evs) for _, _, evs in res)

    rep = fleet.report
    print(f"\nscheme={args.scheme} backend=torch device={device} "
          f"dtype={args.dtype} arch={cfg.name} layers={cfg.num_layers} "
          f"d_model={cfg.d_model} fleet={args.fleet} (async streaming)")
    print(f"  served {len(res)} streams / {n_tok} tokens in "
          f"{elapsed:.1f}s wall ({n_tok / elapsed:.1f} tok/s)")
    print(f"  stream TTFT p50/p99: {_pct(ttfts, 50):.2f}/"
          f"{_pct(ttfts, 99):.2f}s  TBT p99: {_pct(tbts, 99)*1e3:.0f}ms")
    print(f"  server wall TBT p50/p95/p99: {wall['tbt_p50']*1e3:.0f}/"
          f"{wall['tbt_p95']*1e3:.0f}/{wall['tbt_p99']*1e3:.0f}ms over "
          f"{wall['n_tokens']} tokens")
    print(f"  barriers: {rep.ticks}  migrations: {rep.migrations} "
          f"(live {rep.live_migrations}, offload-transfer "
          f"{rep.offload_transfers})  kv moved: "
          f"{rep.kv_moved_bytes/1e6:.1f} MB")
    some = {rid: [t for _, t, _ in evs[:8]] for rid, _, evs in res[:3]}
    print(f"  sample streamed token ids: {some}")
    _finish_trace(args, rec, fleet.all_requests())
    return fleet


if __name__ == "__main__":
    main()
