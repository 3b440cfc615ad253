"""The benchmark's frozen copies give the originals' numbers today: the
traffic arithmetic of ``repro_torch/data/workloads.py``, the percentile
of ``repro_torch/serving/metrics.py`` and the kernel work and bound of
``chip_smoke.py``."""
import types

import numpy as np
import pytest
import torch

import chip_smoke
from nbench import records, traffic, yardstick
from repro_torch.core.qos import PAPER_TIERS
from repro_torch.data import workloads
from repro_torch.serving import metrics


@pytest.mark.parametrize("name", sorted(workloads.DATASETS))
def test_lengths_and_draws_match_the_program(name):
    ds = workloads.DATASETS[name]
    for orig in (ds.prompt, ds.decode):
        mine = traffic.LengthDist(orig.p50, orig.p90, orig.lo, orig.hi)
        assert (mine.mu, mine.sigma) == (orig.mu, orig.sigma)
        assert np.array_equal(mine.sample(np.random.default_rng(3), 500),
                              orig.sample(np.random.default_rng(3), 500))
    arr = workloads.poisson_arrivals(np.random.default_rng(5), 4.0, 60.0)
    reqs = workloads.make_requests(ds, arr, np.random.default_rng(9))
    p, d, t = traffic.paper_draws(
        traffic.LengthDist(ds.prompt.p50, ds.prompt.p90, ds.prompt.lo,
                           ds.prompt.hi),
        traffic.LengthDist(ds.decode.p50, ds.decode.p90, ds.decode.lo,
                           ds.decode.hi),
        len(arr), np.random.default_rng(9), len(PAPER_TIERS),
        [1.0 / len(PAPER_TIERS)] * len(PAPER_TIERS))
    assert [r.prompt_len for r in reqs] == list(p)
    assert [r.decode_len for r in reqs] == list(d)
    assert [r.qos.name for r in reqs] == [PAPER_TIERS[i].name for i in t]


@pytest.mark.parametrize("q", [50, 90, 95, 99])
def test_percentile_matches_the_program(q):
    xs = list(np.random.default_rng(q).lognormal(0, 1, 257))
    assert records._pct(xs, q) == metrics._pct(xs, q)
    assert np.isnan(records._pct([], q)) and np.isnan(metrics._pct([], q))
    assert records.pct([], q) is None


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bound_matches_chip_smoke(dtype):
    for nbytes, flops in ((1e9, 1e9), (1e6, 1e14), (3.3e9, 9.9e14)):
        assert yardstick.bound_ms(nbytes, flops, dtype) == \
            chip_smoke.bound_ms(nbytes, flops, dtype)


def _decode_case(rng, dtype, lens, H=8, KV=2, D=64, page=16):
    B = len(lens)
    n_pages = max(-(-n // page) for n in lens)
    q = torch.randn(B, H, D, dtype=dtype)
    kp = torch.randn(B * n_pages + 1, page, KV, D, dtype=dtype)
    bt = torch.full((B, n_pages), -1, dtype=torch.int32)
    perm = rng.permutation(B * n_pages)
    for b, n in enumerate(lens):
        k = -(-n // page)
        bt[b, :k] = torch.from_numpy(perm[b * n_pages:b * n_pages + k])
    return q, kp, bt, torch.tensor(lens, dtype=torch.int32)


@pytest.mark.parametrize("quant", [False, True])
def test_paged_work_matches_chip_smoke(quant):
    q, kp, bt, lens = _decode_case(np.random.default_rng(1), torch.bfloat16,
                                   [5, 64, 100, 1])
    assert yardstick._paged_work(q, kp, bt, lens, quant) == \
        chip_smoke._paged_work(q, kp, bt, lens, quant)


def _cpu_arange(torch_mod):
    """chip_smoke builds its prefill mask on "cuda"; the same arithmetic
    on the CPU."""
    shim = types.SimpleNamespace(
        arange=lambda *a, device=None, **k: torch_mod.arange(*a, **k))
    return shim


@pytest.mark.parametrize("window", [None, 40])
def test_prefill_work_matches_chip_smoke(monkeypatch, window):
    B, C, H, KV, D, S = 3, 48, 8, 2, 64, 160
    q = torch.randn(B, C, H, D, dtype=torch.bfloat16)
    k = torch.randn(B, S, KV, D, dtype=torch.bfloat16)
    offs = torch.tensor([0, 30, 100], dtype=torch.int32)
    kv = torch.tensor([48, 70, 0], dtype=torch.int32)
    mine = yardstick._prefill_work(q, k, offs, kv, window)
    monkeypatch.setattr(chip_smoke, "torch", _cpu_arange(torch))
    assert mine == chip_smoke._prefill_work(q, k, offs, kv, window)


def test_plan_work_is_the_copies_count_over_real_rows():
    """A plan's real rows, each alone and unpadded, counted by the frozen
    tensor versions, sum to the closed forms."""
    rng = np.random.default_rng(2)
    H, KV, D, page = 8, 2, 64, 16
    ctxs = [5, 64, 100, 1]
    q, kp, bt, lens = _decode_case(rng, torch.bfloat16, ctxs, H, KV, D,
                                   page)
    got = yardstick.decode_work(ctxs, H, KV, D, page, 2)
    live_b, live_f = yardstick._paged_work(q, kp, bt, lens)
    # the closed form counts each row's own pages of table, not B x max
    assert got[1] == live_f
    assert got[0] == live_b - bt.numel() * 4 + sum(
        -(-c // page) for c in ctxs) * 4
    chunks = [(0, 48), (30, 17), (100, 1)]
    nb = fl = 0.0
    for start, real in chunks:
        qq = torch.randn(1, real, H, D, dtype=torch.bfloat16)
        kk = torch.randn(1, start + real, KV, D, dtype=torch.bfloat16)
        b, f = yardstick._prefill_work(
            qq, kk, torch.tensor([start], dtype=torch.int32),
            torch.tensor([start + real], dtype=torch.int32))
        nb, fl = nb + b, fl + f
    assert yardstick.prefill_work(chunks, H, KV, D, 2) == (nb, fl)
