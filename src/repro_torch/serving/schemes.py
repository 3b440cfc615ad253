"""Scheme factories: one-call construction of the paper's systems, as in
the JAX package's ``serving/schemes.py``.

  niyama            — full system (DC + HP + ER + selective preemption)
  niyama-dc         — dynamic chunking only (ablation, Table 3)
  niyama-dc-er      — + eager relegation
  sarathi-fcfs/edf/srpf/sjf — shared-cluster baselines, fixed chunk 256
  sarathi-silo      — per-tier fleets: strict tier chunk 256, others 2048

``make_replica``, ``make_silo``, ``make_fleet`` and ``run_fleet_workload``
build and drive the simulator's deployments, copied from the JAX package.
``make_torch_replica`` is the counterpart of ``make_jax_replica``: the
same scheduler and replica code, backed by the fused ``TorchEngine``
(paged or dense KV layout) or the ``ReferenceTorchEngine``, with the KV
hierarchy (prefix cache, host-swap tier) when a ``KVCacheConfig`` asks
for it. ``make_async_torch_fleet`` is the
counterpart of ``make_async_jax_fleet`` over such replicas.
"""
from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional, Sequence

import torch

from repro_torch.core.kvpool import KVPool, kv_bytes_per_block
from repro_torch.core.predictor import A100, HardwareSpec, ModelCostModel
from repro_torch.core.qos import QoSSpec
from repro_torch.core.request import Request
from repro_torch.core.scheduler import (NiyamaConfig, NiyamaScheduler,
                                        SarathiScheduler)
from repro_torch.models.config import ModelConfig
from repro_torch.serving.cluster import Cluster, make_silo_cluster
from repro_torch.serving.fleet.controller import FleetController
from repro_torch.serving.fleet.router import Router
from repro_torch.serving.kvcache import KVCacheConfig, KVHierarchy
from repro_torch.serving.metrics import MetricsReport, compute_metrics
from repro_torch.serving.replica import Replica
from repro_torch.sim.backend import SimBackend

SHARED_CHUNK = 256        # strictest tier's TBT-safe chunk (paper §4)
SILO_BATCH_CHUNK = 2048   # throughput chunk for relaxed-tier silos

# CPU-scale hardware and QoS tiers for the real engine on the CPU (copied
# from the JAX package's schemes.py, so both stacks schedule alike).
CPU_HW = HardwareSpec("cpu-demo", flops_peak=5e10, hbm_bw=1e10,
                      hbm_size=8e9, link_bw=1e9, mfu=0.8,
                      overhead_s=5e-3)

CPU_TIERS = (
    QoSSpec("Q1", interactive=True, ttft_slo=20.0, tbt_slo=2.0),
    QoSSpec("Q2", interactive=False, ttlt_slo=120.0),
    QoSSpec("Q3", interactive=False, ttlt_slo=360.0),
)


def _kv_pool(cfg: ModelConfig, hw: HardwareSpec, tp: int,
             kv_cfg: Optional[KVCacheConfig] = None) -> KVPool:
    # Budget against ONE device's HBM with per-shard block bytes
    # (tp_degree): when the kv heads divide this equals the old
    # aggregate hbm*tp math exactly, and when they don't (pages
    # replicate) it stops over-counting the budget by the TP factor.
    if kv_cfg is None:
        return KVPool.from_memory(cfg, hw.hbm_size, tp_degree=tp)
    return KVHierarchy.from_memory(cfg, hw.hbm_size, cache_cfg=kv_cfg,
                                   tp_degree=tp)


def make_replica(scheme: str, cfg: ModelConfig, hw: HardwareSpec = A100,
                 tp: int = 1, rid: int = 0, seed: int = 0,
                 niyama_overrides: Optional[dict] = None,
                 sim_noise: float = 0.03,
                 kv_cfg: Optional[KVCacheConfig] = None) -> Replica:
    cost = ModelCostModel(cfg, hw, tp=tp)
    backend = SimBackend.perturbed(cost, seed=seed + rid,
                                   noise=sim_noise)
    kv = _kv_pool(cfg, hw, tp, kv_cfg)
    if scheme.startswith("niyama"):
        over = dict(niyama_overrides or {})
        if scheme == "niyama-dc":
            over.update(enable_relegation=False, enable_hybrid=False)
        elif scheme == "niyama-dc-er":
            over.update(enable_hybrid=False)
        ncfg = NiyamaConfig(**over)
        sched = NiyamaScheduler(cost, cfg=ncfg)
    elif scheme.startswith("sarathi-"):
        policy = scheme.split("-", 1)[1]
        sched = SarathiScheduler(cost, policy=policy,
                                 chunk_size=SHARED_CHUNK)
    else:
        raise ValueError(f"unknown scheme {scheme!r}")
    return Replica(scheduler=sched, backend=backend, kv=kv, rid=rid)


def make_torch_replica(scheme: str, cfg: ModelConfig, *,
                       engine: str = "fused", kv_layout: str = "paged",
                       n_slots: int = 8, max_len: int = 256,
                       block_size: int = 64,
                       kv_blocks: Optional[int] = None, quantum: int = 32,
                       seed: int = 0, hw: HardwareSpec = CPU_HW,
                       device="cuda", dtype=torch.float32,
                       params: Optional[Mapping[str, torch.Tensor]] = None,
                       kv_cfg: Optional[KVCacheConfig] = None,
                       tp: int = 1,
                       backend_wrap: Optional[Callable] = None) -> Replica:
    """The scheduler, a ``KVPool`` and an engine on ``device``, sized and
    refused as ``make_jax_replica`` does. ``engine``: ``"fused"``
    (``TorchEngine``) or ``"reference"`` (``ReferenceTorchEngine``, which
    runs exact-length chunks, ``quantum=1``, and ignores the pool's
    grants). Paged layout (default): the pool is block-granular
    (``kv_blocks`` blocks of ``block_size`` tokens, by default enough for
    every slot at ``max_len``) and shared between scheduler accounting
    and the fused engine's pages; ``kv_cfg`` makes it a ``KVHierarchy``
    (prefix cache and host-swap tier, priced at fp32 bytes per block as
    in the JAX factory), which needs the paged fused engine. Dense
    layout: one block of ``max_len`` per slot, no hierarchy. ``params``
    goes to the engine (a ``state_dict``); ``backend_wrap`` optionally
    wraps the engine (e.g. a fixed-clock shim for token-stream
    comparisons). ``tp`` > 1 serves the fused engine over ``tp`` ranks
    (``TorchEngine(tp=)``, which starts the other ranks; stop them with
    ``replica.backend.close()``) and prices the collective term into the
    scheduler's cost model, as in JAX."""
    from repro_torch.engine.torch_backend import make_engine

    cost = ModelCostModel(cfg, hw, tp=tp)
    if kv_layout == "paged":
        if kv_blocks is None:
            kv_blocks = n_slots * ((max_len + block_size - 1) // block_size)
        if kv_cfg is not None:
            if engine != "fused":
                raise ValueError("the KV hierarchy needs the paged fused "
                                 "engine (reference is slot-sequential)")
            kv = KVHierarchy(kv_blocks, block_size, cfg=kv_cfg,
                             bytes_per_block=kv_bytes_per_block(
                                 cfg, block_size, bytes_per=4),
                             max_seqs=n_slots)
        else:
            kv = KVPool(kv_blocks, block_size, max_seqs=n_slots)
    else:
        if kv_cfg is not None:
            raise ValueError("prefix cache / host swap need kv_layout="
                             "'paged' (dense slots cannot share pages)")
        # one block == one engine slot: admission exactly mirrors slots
        kv = KVPool(num_blocks=n_slots, block_size=max_len)
    ekw = dict(n_slots=n_slots, max_len=max_len, seed=seed, dtype=dtype,
               params=params, device=device)
    if engine == "fused":
        ekw.update(quantum=quantum, kv_layout=kv_layout, tp=tp)
        if kv_layout == "paged":
            ekw.update(pool=kv)
    elif tp > 1:
        raise ValueError("tp > 1 requires the fused engine (the "
                         "reference oracle is single-device by design)")
    else:
        ekw.update(quantum=1)
    backend = make_engine(engine, cfg, **ekw)
    if backend_wrap is not None:
        backend = backend_wrap(backend)
    if scheme.startswith("niyama"):
        sched = NiyamaScheduler(cost, cfg=NiyamaConfig(
            max_chunk=max_len, quantum=quantum, fixed_chunk=64,
            max_decode_batch=n_slots))
    elif scheme.startswith("sarathi-"):
        sched = SarathiScheduler(cost, policy=scheme.split("-", 1)[1],
                                 chunk_size=64, max_decode_batch=n_slots)
    else:
        raise ValueError(f"unknown scheme {scheme!r}")
    return Replica(scheduler=sched, backend=backend, kv=kv)


def make_silo(cfg: ModelConfig, per_tier: Dict[str, int],
              hw: HardwareSpec = A100, tp: int = 1, seed: int = 0,
              sim_noise: float = 0.03) -> Cluster:
    """Sarathi-Silo (SOTA baseline): each tier gets its own fleet; the
    strict interactive tier runs chunk 256, batch tiers run chunk 2048."""
    cost = ModelCostModel(cfg, hw, tp=tp)

    def factory(tier: str, rid: int) -> Replica:
        chunk = SHARED_CHUNK if tier == "Q1" else SILO_BATCH_CHUNK
        sched = SarathiScheduler(ModelCostModel(cfg, hw, tp=tp),
                                 policy="fcfs", chunk_size=chunk)
        backend = SimBackend.perturbed(cost, seed=seed + rid,
                                       noise=sim_noise)
        return Replica(scheduler=sched, backend=backend,
                       kv=_kv_pool(cfg, hw, tp), rid=rid)

    return make_silo_cluster(per_tier, factory)


def make_fleet(cfg: ModelConfig, n: int, scheme: str = "niyama",
               policy: str = "slack", hw: HardwareSpec = A100, tp: int = 1,
               seed: int = 0, sim_noise: float = 0.03,
               offload: bool = True, migrate: bool = True,
               live_migrate: bool = False,
               kv_cfg: Optional[KVCacheConfig] = None,
               controller_cls: type = FleetController,
               **controller_kw) -> FleetController:
    """The online fleet deployment: ``n`` shared replicas behind a dynamic
    router (default predicted-slack-aware), with cross-replica relegation
    offload and queued-prefill migration. ``kv_cfg`` equips every replica
    with the KV memory hierarchy (prefix cache / host-swap tier) and
    ``live_migrate=True`` enables in-flight decode KV-transfer migration.
    ``relegated_park_s`` (first-class, default 2 ticks) is wired into the
    replicas at construction by the controller. Compare against
    :func:`make_silo` and the offline ``make_shared_cluster``."""
    replicas = [make_replica(scheme, cfg, hw=hw, tp=tp, rid=i, seed=seed,
                             sim_noise=sim_noise, kv_cfg=kv_cfg)
                for i in range(n)]
    router = Router(replicas, policy=policy)
    return controller_cls(replicas, router, offload=offload,
                          migrate=migrate, live_migrate=live_migrate,
                          **controller_kw)


def make_async_torch_fleet(cfg: ModelConfig, n: int, scheme: str = "niyama",
                           policy: str = "slack", *, n_slots: int = 4,
                           max_len: int = 256, block_size: int = 64,
                           kv_blocks: Optional[int] = None,
                           quantum: int = 32, seed: int = 0,
                           hw: HardwareSpec = CPU_HW, device="cuda",
                           dtype=torch.float32,
                           params: Optional[Mapping[str,
                                                    torch.Tensor]] = None,
                           kv_cfg: Optional[KVCacheConfig] = None,
                           backend_wrap: Optional[Callable] = None,
                           clock=None, live_migrate: bool = True,
                           **controller_kw):
    """The async real-engine fleet: ``n`` ``TorchEngine`` replicas on
    ``device`` in ``dtype`` (built through :func:`make_torch_replica`, so
    the solo and fleet stacks cannot drift) behind an
    :class:`~repro_torch.serving.asyncfleet.AsyncFleet`, with a wall
    clock unless ``clock`` is given.

    Every replica gets the SAME engine ``seed`` (and the same ``params``
    when given): identical weights and identical per-rid synthetic
    prompts are what make any request's token stream comparable to one
    replica's regardless of routing or migration. The default ``kv_cfg``
    enables the full hierarchy (prefix cache + host-swap tier); the swap
    tier is required for real KV transfers, which stage through the
    destination's host tier. ``backend_wrap`` wraps each engine (e.g. a
    fixed-clock shim; the runtime finds the engine through ``.inner``)."""
    from repro_torch.serving.asyncfleet import AsyncFleet, WallClock

    if kv_cfg is None:
        kv_cfg = KVCacheConfig(enable_prefix=True, enable_swap=True,
                               host_bytes=1e9)
    replicas = []
    for i in range(n):
        rep = make_torch_replica(scheme, cfg, n_slots=n_slots,
                                 max_len=max_len, block_size=block_size,
                                 kv_blocks=kv_blocks, quantum=quantum,
                                 seed=seed, hw=hw, device=device,
                                 dtype=dtype, params=params, kv_cfg=kv_cfg,
                                 backend_wrap=backend_wrap)
        rep.rid = i
        replicas.append(rep)
    router = Router(replicas, policy=policy)
    return AsyncFleet(replicas, router,
                      clock=clock if clock is not None else WallClock(),
                      live_migrate=live_migrate, **controller_kw)


def run_fleet_workload(fleet: FleetController, requests: Sequence[Request],
                       until: Optional[float] = None,
                       duration: Optional[float] = None,
                       long_threshold: Optional[int] = None
                       ) -> MetricsReport:
    """Drive a fleet over a request trace; the returned report carries the
    fleet telemetry (``report.fleet``)."""
    fleet.submit(list(requests))
    fleet.run(until=until)
    if duration is None:
        duration = max((r.arrival for r in requests), default=0.0)
    return compute_metrics(fleet.all_requests(),
                           duration=max(duration, 1e-9),
                           long_p90_threshold=long_threshold,
                           fleet=fleet.report)


ALL_SHARED_SCHEMES = ("niyama", "sarathi-fcfs", "sarathi-edf",
                      "sarathi-srpf", "sarathi-sjf")
