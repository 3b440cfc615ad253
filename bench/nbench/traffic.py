"""Traffic: one general generator driven by a mix's data file.

``LengthDist`` and ``paper_draws`` are frozen copies of the arithmetic
of ``repro_torch/data/workloads.py`` (the lognormal fitted to a
dataset's p50 and p90, one tier per request with equal probability), so a later change to the program's
generator cannot move the yardstick. ``bench/tests/test_bench_copies.py``
holds them to the original.

A mix file (``bench/traffic/<mix>.json``) names the dataset's p50 / p90
of prompt and output lengths, their clip, the tiers and their shares,
the arrival process and its rate, the ramp's seconds and the seed of the
set. ``schedule`` draws one fixed set of sizes, tiers and arrival times
from the mix's own ``set_seed``, so every run of a cell offers the same
work; the run's ``--seed`` only permutes which size arrives at which
time and makes the prompts' token ids. A mix may give ``reorder_block``:
the seed then permutes each run of that many consecutive arrivals alone,
so every request keeps its place within a second or so, and with it how
its decode overlaps the others' prefills.
"""
from __future__ import annotations

import json
import math
from dataclasses import dataclass
from pathlib import Path
from typing import List, Sequence

import numpy as np

_Z90 = 1.2815515655446004


@dataclass(frozen=True)
class LengthDist:
    """Lognormal parameterized by its p50/p90 (the paper's Table 1)."""
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


def paper_draws(prompt: LengthDist, decode: LengthDist, n: int,
                rng: np.random.Generator, n_tiers: int,
                tier_probs: Sequence[float]):
    """Prompt lengths, output lengths and tier indices of ``n`` requests,
    in the draw order of the program's ``make_requests``."""
    prompts = prompt.sample(rng, n)
    decodes = decode.sample(rng, n)
    tier_idx = rng.choice(n_tiers, size=n, p=list(tier_probs))
    return prompts, decodes, tier_idx


@dataclass(frozen=True)
class Tier:
    name: str
    interactive: bool
    ttft_slo: float = None
    tbt_slo: float = None
    ttlt_slo: float = None


@dataclass
class Item:
    """One request of the schedule: due ``offset`` seconds after the
    ramp opens; ``in_window`` when its due time lies in the window."""
    rid: int
    offset: float
    prompt_len: int
    decode_len: int
    tier: int
    in_window: bool


@dataclass
class Mix:
    name: str
    prompt: LengthDist
    decode: LengthDist
    max_len: int
    tiers: List[Tier]
    tier_probs: List[float]
    rate: float
    ramp_s: float
    set_seed: int
    reorder_block: int = 0

    @classmethod
    def load(cls, path: Path) -> "Mix":
        d = json.loads(Path(path).read_text())
        return cls(
            name=d["name"],
            prompt=LengthDist(*d["prompt"]["p50_p90"],
                              *d["prompt"]["clip"]),
            decode=LengthDist(*d["output"]["p50_p90"],
                              *d["output"]["clip"]),
            max_len=int(d["max_len"]),
            tiers=[Tier(**t) for t in d["tiers"]],
            tier_probs=[float(p) for p in d["tier_shares"]],
            rate=float(d["arrivals"]["rate_per_s"]),
            ramp_s=float(d["ramp_s"]),
            set_seed=int(d["set_seed"]),
            reorder_block=int(d.get("reorder_block", 0)))


def _times(rng: np.random.Generator, rate: float, t0: float,
           length: float) -> np.ndarray:
    """A Poisson process over ``[t0, t0 + length)`` conditioned on its
    expected count, ``round(rate * length)``: that many uniform times,
    sorted. Fixing the count keeps every run's load alike."""
    n = int(round(rate * length))
    return np.sort(t0 + rng.uniform(0.0, length, size=n))


def _order(rng: np.random.Generator, n: int, block: int) -> np.ndarray:
    """The seed's order of a part's ``n`` requests: one permutation of
    all of them, or, with ``block``, of each run of ``block`` consecutive
    ones alone."""
    if not block:
        return rng.permutation(n)
    return np.concatenate([i + rng.permutation(min(block, n - i))
                           for i in range(0, n, block)]).astype(np.int64)


def seed_words(seed: int) -> List[int]:
    """Any whole number as two unsigned 32-bit words, for numpy's and
    torch's seeding."""
    s = int(seed) % (1 << 64)
    return [s & 0xFFFFFFFF, s >> 32]


def schedule(mix: Mix, seconds: float, seed: int,
             rate: float = None) -> List[Item]:
    """The requests of one run: the ramp's, then the window's. Sizes,
    tiers and times come from ``mix.set_seed``; ``seed`` permutes the
    sizes and tiers over the times, within the ramp and within the
    window separately (within blocks of ``mix.reorder_block``). A request's prompt plus output never passes
    ``mix.max_len``: a prompt that would is cut to fit."""
    rate = mix.rate if rate is None else rate
    base = np.random.default_rng(mix.set_seed)
    parts = []
    for t0, length in ((0.0, mix.ramp_s), (mix.ramp_s, float(seconds))):
        times = _times(base, rate, t0, length)
        prompts, decodes, tiers = paper_draws(
            mix.prompt, mix.decode, len(times), base, len(mix.tiers),
            mix.tier_probs)
        prompts = np.minimum(prompts, mix.max_len - decodes)
        parts.append((times, prompts, decodes, tiers, t0 > 0))
    perm_rng = np.random.default_rng(seed_words(seed) + [17])
    items: List[Item] = []
    for times, prompts, decodes, tiers, in_window in parts:
        order = _order(perm_rng, len(times), mix.reorder_block)
        for j, t in enumerate(times):
            k = order[j]
            items.append(Item(len(items), float(t), int(prompts[k]),
                              int(decodes[k]), int(tiers[k]), in_window))
    return items


def prompt_tokens(seed: int, rid: int, n: int, vocab: int) -> np.ndarray:
    """The prompt's token ids, from the run's seed and the request."""
    rng = np.random.default_rng(seed_words(seed) + [1, rid])
    return rng.integers(0, vocab, size=n).astype(np.int32)
