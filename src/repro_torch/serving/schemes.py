"""One-call construction of the port's real-engine serving stack.

``make_torch_replica`` is the counterpart of the JAX package's
``serving/schemes.py::make_jax_replica`` on its paged fused path: the
same scheduler and replica code, backed by ``TorchEngine``, with the KV
hierarchy (prefix cache, host-swap tier) when a ``KVCacheConfig`` asks
for it.
"""
from __future__ import annotations

from typing import Callable, Mapping, Optional

import torch

from repro_torch.core.kvpool import KVPool, kv_bytes_per_block
from repro_torch.core.predictor import HardwareSpec, ModelCostModel
from repro_torch.core.qos import QoSSpec
from repro_torch.core.scheduler import (NiyamaConfig, NiyamaScheduler,
                                        SarathiScheduler)
from repro_torch.models.config import ModelConfig
from repro_torch.serving.kvcache import KVCacheConfig, KVHierarchy
from repro_torch.serving.replica import Replica

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


def make_torch_replica(scheme: str, cfg: ModelConfig, *,
                       n_slots: int = 8, max_len: int = 256,
                       block_size: int = 64,
                       kv_blocks: Optional[int] = None, quantum: int = 32,
                       seed: int = 0, hw: HardwareSpec = CPU_HW,
                       device="cuda", dtype=torch.float32,
                       params: Optional[Mapping[str, torch.Tensor]] = None,
                       kv_cfg: Optional[KVCacheConfig] = None,
                       backend_wrap: Optional[Callable] = None) -> Replica:
    """The scheduler, a block-granular ``KVPool`` (``kv_blocks`` blocks
    of ``block_size`` tokens, by default enough for every slot at
    ``max_len``) shared between scheduler accounting and the engine's
    pages, and a ``TorchEngine`` on ``device``. ``kv_cfg`` makes the
    pool a ``KVHierarchy`` (prefix cache and host-swap tier, priced at
    fp32 bytes per block as in the JAX factory) working on the engine's
    pages. ``params`` goes to the engine (a ``state_dict``);
    ``backend_wrap`` optionally wraps the engine (e.g. a fixed-clock shim
    for token-stream comparisons)."""
    from repro_torch.engine.torch_backend import TorchEngine

    cost = ModelCostModel(cfg, hw)
    if kv_blocks is None:
        kv_blocks = n_slots * ((max_len + block_size - 1) // block_size)
    if kv_cfg is not None:
        kv = KVHierarchy(kv_blocks, block_size, cfg=kv_cfg,
                         bytes_per_block=kv_bytes_per_block(
                             cfg, block_size, bytes_per=4),
                         max_seqs=n_slots)
    else:
        kv = KVPool(kv_blocks, block_size, max_seqs=n_slots)
    backend = TorchEngine(cfg, n_slots=n_slots, max_len=max_len,
                          quantum=quantum, seed=seed, dtype=dtype,
                          pool=kv, params=params, device=device)
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
