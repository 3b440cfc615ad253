"""Workload generation (paper §4 Workloads and QoS Tiers, Table 1/2).

Prompt/decode token counts follow lognormal fits to the published p50/p90
of each dataset; arrivals are Poisson (as in the paper, following
Sarathi/vAttention methodology); each request is assigned one of the three
QoS tiers with equal probability; an ``important`` fraction models the
paid-tier application hint used by eager relegation.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence

import numpy as np

from repro_torch.core.qos import PAPER_TIERS, QoSSpec
from repro_torch.core.request import Request

_Z90 = 1.2815515655446004


@dataclass(frozen=True)
class LengthDist:
    """Lognormal parameterized by its p50/p90 (Table 1)."""
    p50: int
    p90: int
    lo: int = 8
    hi: int = 32768

    @property
    def mu(self) -> float:
        return math.log(self.p50)

    @property
    def sigma(self) -> float:
        return max(1e-3, (math.log(self.p90) - math.log(self.p50)) / _Z90)

    def sample(self, rng: np.random.Generator, n: int) -> np.ndarray:
        x = rng.lognormal(self.mu, self.sigma, size=n)
        return np.rint(np.clip(x, self.lo, self.hi)).astype(int)


@dataclass(frozen=True)
class Dataset:
    name: str
    prompt: LengthDist
    decode: LengthDist

    def long_threshold(self) -> int:
        return self.prompt.p90


# Table 1
SHAREGPT = Dataset("sharegpt", LengthDist(1730, 5696),
                   LengthDist(415, 834, lo=1, hi=4096))
AZURE_CONV = Dataset("azure_conv", LengthDist(928, 3830),
                     LengthDist(41, 342, lo=1, hi=4096))
AZURE_CODE = Dataset("azure_code", LengthDist(1930, 6251),
                     LengthDist(8, 43, lo=1, hi=4096))
DATASETS = {d.name: d for d in (SHAREGPT, AZURE_CONV, AZURE_CODE)}


def poisson_arrivals(rng: np.random.Generator, qps: float,
                     duration: float) -> np.ndarray:
    n = rng.poisson(qps * duration)
    return np.sort(rng.uniform(0.0, duration, size=n))


def diurnal_arrivals(rng: np.random.Generator, qps_low: float,
                     qps_high: float, period: float,
                     duration: float) -> np.ndarray:
    """Paper §4.3: load alternates low/high every ``period`` seconds."""
    ts: List[float] = []
    t = 0.0
    high = False
    while t < duration:
        seg = min(period, duration - t)
        qps = qps_high if high else qps_low
        ts.extend(t + poisson_arrivals(rng, qps, seg))
        t += seg
        high = not high
    return np.sort(np.asarray(ts))


def make_requests(dataset: Dataset, arrivals: Sequence[float],
                  rng: np.random.Generator,
                  tiers: Sequence[QoSSpec] = PAPER_TIERS,
                  tier_probs: Optional[Sequence[float]] = None,
                  important_frac: float = 1.0,
                  rid_base: int = 0) -> List[Request]:
    n = len(arrivals)
    prompts = dataset.prompt.sample(rng, n)
    decodes = dataset.decode.sample(rng, n)
    tier_probs = tier_probs or [1.0 / len(tiers)] * len(tiers)
    tier_idx = rng.choice(len(tiers), size=n, p=tier_probs)
    important = rng.uniform(size=n) < important_frac
    reqs = []
    for i, t in enumerate(arrivals):
        q = tiers[tier_idx[i]]
        reqs.append(Request(
            rid=rid_base + i, arrival=float(t),
            prompt_len=int(prompts[i]), decode_len=int(decodes[i]),
            qos=q, app_id=f"{dataset.name}/{q.name}",
            important=bool(important[i])))
    return reqs


def paper_workload(dataset_name: str, qps: float, duration: float,
                   seed: int = 0, important_frac: float = 1.0
                   ) -> List[Request]:
    """The paper's standard workload: Poisson arrivals at ``qps`` over
    ``duration`` seconds, three equal QoS tiers (Table 2)."""
    rng = np.random.default_rng(seed)
    ds = DATASETS[dataset_name]
    arr = poisson_arrivals(rng, qps, duration)
    return make_requests(ds, arr, rng, important_frac=important_frac)


# ---------------------------------------------------------------------
# Multi-tenant shared-prefix workloads (KV memory hierarchy, docs/kvcache.md)
# ---------------------------------------------------------------------

# per-tenant system-prompt length (tokens); ~1k median mirrors production
# agent/system prompts, long tail up to a few thousand
TENANT_PREFIX = LengthDist(1024, 3072, lo=256, hi=8192)


def assign_shared_prefixes(reqs: Sequence[Request],
                           rng: np.random.Generator,
                           n_tenants: int = 8,
                           prefix_dist: LengthDist = TENANT_PREFIX,
                           tenant_skew: float = 1.0) -> List[Request]:
    """Overlay multi-tenant shared-system-prompt structure on a workload.

    Each request belongs to one tenant (Zipf-ish popularity, exponent
    ``tenant_skew``); the tenant's system prompt occupies the first
    ``prefix_len`` tokens of the request's prompt. The prefix is *carved
    out of* the existing prompt length (clamped to leave >= 1 unique
    token), so total token load is identical to the un-annotated
    workload — only the sharing structure differs. That makes A/B runs
    with the prefix cache on/off directly comparable."""
    w = 1.0 / np.arange(1, n_tenants + 1, dtype=np.float64) ** tenant_skew
    w /= w.sum()
    prefix_lens = prefix_dist.sample(rng, n_tenants)
    tenants = rng.choice(n_tenants, size=len(reqs), p=w)
    for req, tid in zip(reqs, tenants):
        req.prefix_id = int(tid)
        req.prefix_len = int(min(prefix_lens[tid],
                                 max(0, req.prompt_len - 1)))
        req.app_id = f"{req.app_id}/t{tid}"
    return list(reqs)


def shared_prefix_workload(dataset_name: str, qps: float, duration: float,
                           seed: int = 0, n_tenants: int = 8,
                           important_frac: float = 1.0,
                           tier_probs: Optional[Sequence[float]] = None,
                           tenant_skew: float = 1.0) -> List[Request]:
    """Poisson multi-tenant workload where requests of a tenant share that
    tenant's system prompt — the predictable structure the KV hierarchy's
    prefix cache turns into reclaimed prefill capacity."""
    rng = np.random.default_rng(seed)
    ds = DATASETS[dataset_name]
    arr = poisson_arrivals(rng, qps, duration)
    reqs = make_requests(ds, arr, rng, tier_probs=tier_probs,
                         important_frac=important_frac)
    return assign_shared_prefixes(reqs, rng, n_tenants=n_tenants,
                                  tenant_skew=tenant_skew)
