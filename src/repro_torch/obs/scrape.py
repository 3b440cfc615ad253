"""Scrape pass: mirror the serving stack's live counters into a
``MetricsRegistry`` (docs/observability.md §Registry).

The repo's counters predate the registry and live where they are cheap to
maintain (``Replica.backpressure_defers``, ``KVPool.free``,
``PrefixCache.hit_tokens``, ``TorchEngine.buckets_seen``,
``EngineWorker.publishes``, ``FleetReport.*``). Rather than rewriting
every hot path to call the registry — which would put metric plumbing in
bit-identity-critical code — this pass reads them all at observation
points: per lockstep barrier in virtual mode, per soft barrier in wall
mode (``FleetController._observe``), and on every ``/metrics`` request.
Cumulative sources go through ``Counter.set_total`` so they stay
monotonic; instantaneous ones are gauges.
"""
from __future__ import annotations


def _engine_of(rep):
    """The real ``TorchEngine`` behind a replica's backend (unwraps
    ``.inner`` shims), or None for sim backends and the reference engine
    (which has no ``_swap_store``). Duplicated from the async runtime
    so scraping never imports the serving stack."""
    be = getattr(rep, "backend", None)
    for _ in range(4):
        if be is None:
            return None
        if hasattr(be, "_swap_store"):
            return be
        be = getattr(be, "inner", None)
    return None


def scrape_replica(reg, rep, worker=None) -> None:
    """Mirror one replica's (and its engine's / worker's) counters."""
    lab = {"replica": rep.rid}
    reg.gauge("repro_kv_blocks_free",
              "free KV blocks in the replica's pool",
              ("replica",)).set(rep.kv.free, **lab)
    reg.gauge("repro_kv_blocks_used",
              "allocated (non-reclaimable) KV blocks",
              ("replica",)).set(rep.kv.used, **lab)
    reg.gauge("repro_kv_utilization", "KV pool utilization [0,1]",
              ("replica",)).set(rep.kv.utilization(), **lab)
    qd = reg.gauge("repro_queue_depth", "requests per replica queue",
                   ("replica", "queue"))
    qd.set(len(rep.prefill_queue), queue="prefill", **lab)
    qd.set(len(rep.decode_queue), queue="decode", **lab)
    qd.set(len(rep.relegated_queue), queue="relegated", **lab)
    reg.counter("repro_iterations_total", "executed scheduler iterations",
                ("replica",)).set_total(rep.iterations, **lab)
    reg.counter("repro_busy_seconds_total",
                "seconds spent executing iterations",
                ("replica",)).set_total(rep.busy_time, **lab)
    reg.counter("repro_backpressure_defers_total",
                "iterations with an engine-backpressure prefill deferral",
                ("replica",)).set_total(rep.backpressure_defers, **lab)

    kv = rep.kv
    if hasattr(kv, "host_utilization"):
        reg.gauge("repro_host_utilization",
                  "host swap-tier occupancy [0,1]",
                  ("replica",)).set(kv.host_utilization(), **lab)
    prefix = getattr(kv, "prefix", None)
    if prefix is not None:
        reg.counter("repro_prefix_hit_tokens_total",
                    "prefill tokens skipped via prefix-cache hits",
                    ("replica",)).set_total(prefix.hit_tokens, **lab)
        reg.counter("repro_prefix_miss_tokens_total",
                    "shareable prefill tokens that missed the cache",
                    ("replica",)).set_total(prefix.miss_tokens, **lab)
    if hasattr(kv, "swapped_out_bytes_total"):
        reg.counter("repro_swap_out_bytes_total",
                    "KV bytes relegated HBM -> host tier",
                    ("replica",)).set_total(kv.swapped_out_bytes_total,
                                            **lab)
        reg.counter("repro_swap_in_bytes_total",
                    "KV bytes swapped host tier -> HBM",
                    ("replica",)).set_total(kv.swapped_in_bytes_total,
                                            **lab)

    eng = _engine_of(rep)
    if eng is not None:
        reg.gauge("repro_engine_shape_buckets",
                  "distinct (rows, chunk) shape buckets served",
                  ("replica",)).set(len(eng.buckets_seen), **lab)
        reg.counter("repro_engine_prefill_rows_total",
                    "prefill rows executed by the fused engine",
                    ("replica",)).set_total(eng.prefill_rows, **lab)
        reg.counter("repro_engine_prefill_tokens_total",
                    "prefill tokens executed by the fused engine",
                    ("replica",)).set_total(eng.prefill_tokens, **lab)
        if hasattr(eng, "kv_blocks_reclaimed"):
            reg.counter("repro_kv_blocks_reclaimed_total",
                        "KV blocks freed mid-stream by SWA page "
                        "reclamation",
                        ("replica",)).set_total(eng.kv_blocks_reclaimed,
                                                **lab)
        # the engine's worker thread may add a key while a /metrics
        # request scrapes on the event loop: sort a snapshot (dict() is
        # one C call under the GIL), never the live dict
        hits = dict(getattr(eng, "gather_bucket_hits", None) or {})
        if hits:
            c = reg.counter("repro_paged_gather_bucket_hits_total",
                            "iterations served per page-window bucket "
                            "(block-table width maxb)",
                            ("replica", "maxb"))
            for mb, n in sorted(hits.items()):
                c.set_total(n, maxb=str(mb), **lab)
        if getattr(eng, "tp", 1) > 1:
            reg.gauge("repro_tp_devices",
                      "devices in the replica's tensor-parallel mesh",
                      ("replica",)).set(eng.tp, **lab)
            c = reg.counter("repro_tp_collective_bytes_total",
                            "interconnect bytes moved by TP all-gathers, "
                            "by op (heads/ffn/experts/logits)",
                            ("replica", "op"))
            for op, b in sorted(dict(eng.tp_collective_bytes).items()):
                c.set_total(b, op=op, **lab)
    if worker is not None:
        reg.counter("repro_worker_publishes_total",
                    "snapshot publishes by the replica's engine worker",
                    ("replica",)).set_total(worker.publishes, **lab)


def scrape_fleet(reg, fleet) -> None:
    """Mirror a whole fleet: every replica plus the controller-level
    report. Works for the lockstep ``FleetController`` and the async
    runtime alike (workers are scraped when the fleet has them)."""
    workers = getattr(fleet, "workers", None)
    for i, rep in enumerate(fleet.replicas):
        scrape_replica(reg, rep,
                       worker=workers[i] if workers is not None else None)
    rpt = fleet.report
    reg.gauge("repro_fleet_replicas", "replicas in the fleet").set(
        rpt.n_replicas)
    reg.counter("repro_fleet_barriers_total",
                "global decision barriers run").set_total(rpt.ticks)
    reg.counter("repro_fleet_offloads_total",
                "relegation offloads via recompute").set_total(
        rpt.offloads)
    reg.counter("repro_fleet_offload_transfers_total",
                "relegation offloads via host-KV transfer").set_total(
        rpt.offload_transfers)
    reg.counter("repro_fleet_rebalances_total",
                "queued-prefill migrations").set_total(rpt.rebalances)
    reg.counter("repro_fleet_live_migrations_total",
                "live KV-transfer decode migrations").set_total(
        rpt.live_migrations)
    reg.counter("repro_fleet_kv_moved_bytes_total",
                "KV bytes moved across the inter-replica link").set_total(
        rpt.kv_moved_bytes)
    reg.counter("repro_requests_submitted_total",
                "requests submitted to the fleet").set_total(
        getattr(fleet, "_n_submitted", 0))
    reg.counter("repro_requests_finished_total",
                "requests finished fleet-wide").set_total(
        sum(len(rep.finished) for rep in fleet.replicas))
