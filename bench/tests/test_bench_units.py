"""Units of the harness: the schedule's fixed set of work, the trace's
reduction, the readers' arithmetic on a hand-made run."""
import types
from pathlib import Path

import numpy as np
import pytest

from conftest import BENCH
from nbench import profile, records, traffic
from nbench.records import ReqRec, Run, StepRec


def _mix(name="code.qwen-7b"):
    return traffic.Mix.load(BENCH / "traffic" / f"{name}.json")


@pytest.mark.parametrize("name", ["code.qwen-7b", "code.qwen3-moe",
                                  "conv.qwen-7b"])
def test_every_seed_offers_the_same_work_in_another_order(name):
    mix = _mix(name)
    a = traffic.schedule(mix, 30, 1)
    b = traffic.schedule(mix, 30, 2 ** 31 + 99)
    key = lambda s: sorted((i.prompt_len, i.decode_len, i.tier, i.in_window)
                           for i in s)
    assert key(a) == key(b)
    assert [i.offset for i in a] == [i.offset for i in b]
    assert [i.prompt_len for i in a] != [i.prompt_len for i in b]
    assert all(i.prompt_len + i.decode_len <= mix.max_len for i in a)
    win = [i for i in a if i.in_window]
    assert len(win) == round(mix.rate * 30)
    assert all(mix.ramp_s <= i.offset < mix.ramp_s + 30 for i in win)


def test_a_reorder_block_permutes_each_block_alone():
    """With ``reorder_block`` every run of that many consecutive arrivals
    holds the same requests on every seed, in another order; without it
    the order is one permutation of the whole part, as before."""
    mix = _mix("conv.qwen-7b")
    assert mix.reorder_block == 4
    a = traffic.schedule(mix, 51, 2 ** 31 + 7)
    b = traffic.schedule(mix, 51, 3 * 2 ** 31 + 1)
    for part in (False, True):
        pa = [i for i in a if i.in_window is part]
        pb = [i for i in b if i.in_window is part]
        key = lambda s: sorted((i.prompt_len, i.decode_len, i.tier)
                               for i in s)
        for j in range(0, len(pa), 4):
            assert key(pa[j:j + 4]) == key(pb[j:j + 4])
        assert [i.prompt_len for i in pa] != [i.prompt_len for i in pb]
    rng, ref = (np.random.default_rng(5) for _ in range(2))
    assert (traffic._order(rng, 37, 0) == ref.permutation(37)).all()
    blocked = traffic._order(np.random.default_rng(5), 37, 4)
    assert sorted(blocked) == list(range(37))
    assert all(j // 4 == k // 4 for j, k in enumerate(blocked))


def test_prompt_tokens_follow_the_seed():
    t = traffic.prompt_tokens(2 ** 31 + 5, 3, 100, 151936)
    assert (t == traffic.prompt_tokens(2 ** 31 + 5, 3, 100, 151936)).all()
    assert not (t == traffic.prompt_tokens(2 ** 31 + 6, 3, 100, 151936)).all()
    assert t.min() >= 0 and t.max() < 151936
    assert traffic.seed_words(-1) == [0xFFFFFFFF, 0xFFFFFFFF]


def _ev(name, a, b, device=False, dev_us=0.0):
    return types.SimpleNamespace(
        name=name, time_range=types.SimpleNamespace(start=a, end=b),
        device_type="DeviceType.CUDA" if device else "DeviceType.CPU",
        device_time_total=dev_us)


def test_trace_reduction():
    ev = [_ev(profile.SPAN, 0, 1000),
          _ev("bench.step", 0, 600), _ev("bench.schedule", 10, 60),
          _ev("bench.wait", 600, 1000), _ev("moe.experts", 100, 200,
                                            dev_us=150.0),
          _ev("gemm", 100, 300, True), _ev("gemm", 250, 400, True),
          _ev("paged_decode_partial_kernel", 500, 550, True),
          _ev("late", 990, 1200, True),
          # a host span's copy on the device timeline is no device work
          _ev("bench.step", 0, 600, True), _ev("moe.experts", 100, 200, True)]
    t = profile.reduce_events(ev, steps=3)
    assert t.window_s == pytest.approx(1e-3)
    assert t.busy_s == pytest.approx((300 + 50 + 10) * 1e-6)
    assert t.kernels["gemm"] == pytest.approx(350e-6)
    assert t.kernels["late"] == pytest.approx(10e-6)
    assert t.spans["moe.experts"] == pytest.approx(150e-6)
    # idle 0-100 (schedule 10-60, the step's own time around it),
    # 400-500 and 550-600 (step), 600-990 (wait)
    assert t.idle["bench.schedule"] == pytest.approx(50e-6)
    assert t.idle["bench.step"] == pytest.approx(200e-6)
    assert t.idle["bench.wait"] == pytest.approx(390e-6)
    assert sum(t.idle.values()) == pytest.approx(t.window_s - t.busy_s)


def _run():
    reqs = [ReqRec(0, 0.5, "Q1", True, 100, 3, False, 0.6, [1.2, 1.3, 2.5]),
            ReqRec(1, 1.5, "Q2", False, 50, 2, True, 1.6, [2.0, 2.2]),
            ReqRec(2, 2.0, "Q1", True, 80, 4, True, 2.1, [2.6, 2.9]),
            ReqRec(3, 2.8, "Q1", True, 80, 4, True, None, [])]
    steps = [StepRec(0.9, 1.2, 0.002, 0.25, 0.01, [(0, 100)], [], 1, 4,
                     10),
             StepRec(1.9, 2.0, 0.004, 0.09, 0.02, [(0, 50)], [100], 2, 6,
                     10),
             StepRec(2.4, 2.6, 0.006, 0.19, 0.03, [(0, 80)], [50], 2, 8,
                     10)]
    return Run(model={}, seconds=2.0, t_open=1.0, t_close=3.0, setup_s=9.0,
               reqs=reqs, steps=steps, serve={"dtype": "bfloat16"})


def _reader(name):
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        name, BENCH / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def test_readers_on_a_hand_made_run():
    run = _run()
    # Q1 gaps ending in the window: 0.1 (1.3), 1.2 (2.5), 0.3 (2.9); the
    # open gap of request 2: 3.0 - 2.9
    assert _reader("tbt_p95_ms.host")(run) == pytest.approx(
        records._pct([100.0, 1200.0, 300.0, 100.0], 95))
    # prompt 100 + 50 + 80, output tokens in [1, 3): 7
    assert _reader("tokens_s")(run) == pytest.approx((230 + 7) / 2.0)
    assert _reader("setup_s")(run) == 9.0
    assert _reader("sched_ms")(run) == pytest.approx(4.0)
    assert _reader("kv_used_pct")(run) == pytest.approx(60.0)
    assert _reader("engine_ms.tbt")(run) == pytest.approx(176.666666, 1e-6)
    assert _reader("predictor_error_ms")(run) == pytest.approx(
        1e3 * (0.24 + 0.07 + 0.16) / 3)
    assert _reader("device_idle_pct")(run) is None
    assert _reader("decode_attn_roofline")(run) is None


def test_a_traced_run_reads_the_host_side_before_the_profiler():
    """In a traced run the host-side readers read only the window's steps
    that returned before the profiler started: here the first two."""
    run = _run()
    run.t_prof = 2.5
    assert [s.t1 for s in run.host_steps()] == [1.2, 2.0]
    assert _reader("sched_ms")(run) == pytest.approx(3.0)
    assert _reader("kv_used_pct")(run) == pytest.approx(50.0)
    assert _reader("engine_ms.tbt")(run) == pytest.approx(170.0)
    assert _reader("predictor_error_ms")(run) == pytest.approx(
        1e3 * (0.24 + 0.07) / 2)
    # Q1 gaps ending in [1, 2.5): 0.1 (1.3); open at 2.5: request 0 since
    # 1.3; request 2 has no token before 2.5
    assert _reader("tbt_p95_ms.host")(run) == pytest.approx(
        records._pct([100.0, 1200.0], 95))
    # the end-to-end readers keep the whole window
    assert _reader("tokens_s")(run) == pytest.approx((230 + 7) / 2.0)


def test_waiting_queue_and_its_slope():
    """Due and not yet begun; the slope is a least-squares fit, so a
    queue that grows by one request a second reads 1, and one that
    stays reads 0, whatever the rate of arrivals."""
    from nbench import harness
    reqs = {i: ReqRec(i, float(i), "Q2", False, 10, 1, True,
                      admitted=None if i % 2 else i + 0.5)
            for i in range(20)}
    assert harness._waiting(reqs, 4.9) == 2      # 1 and 3; 0, 2, 4 begun
    assert harness._slope(reqs, 0.0, 19.0, harness._waiting) == \
        pytest.approx(0.5, abs=0.03)
    steady = {i: ReqRec(i, i * 0.1, "Q2", False, 10, 1, True,
                        admitted=i * 0.1 + 0.05) for i in range(200)}
    assert abs(harness._slope(steady, 1.0, 19.0, harness._waiting)) < 0.01


def test_each_checked_request_is_held_to_the_limit():
    """One request of many with a large mean gap: the mean over all its
    tokens stays under the limit, the largest request's mean does not,
    and ``failed`` counts that request alone."""
    import torch
    from nbench import check
    gaps = [torch.zeros(60) for _ in range(7)] + [torch.full((12,), 0.5)]
    s = check._summary(gaps)
    assert s["mean_logit_gap"] == pytest.approx(6.0 / 432)
    assert s["request_mean_gap"] == pytest.approx(0.5)
    per = {i: dict(check._summary([g]), tokens=len(g))
           for i, g in enumerate(gaps)}
    assert check.failed(per, {"request_mean_gap": 0.075}) == 1
    assert check.failed(per, {"mean_logit_gap": 0.033}) == 0
    assert check.failed(per, {"max_logit_gap": 0.6}) == 0
    assert check.failed(per, {"max_logit_gap": 0.4}) == 1


def test_a_request_of_a_few_tokens_is_left_to_the_mean_over_all():
    """A request with fewer than ``REQUEST_TOKENS`` checked tokens is not
    held alone (its mean is one or two tokens' gaps), unless no checked
    request is that long: then the longest is."""
    import torch
    from nbench import check
    gaps = [torch.zeros(40), torch.tensor([0.0, 0.09])]
    assert check._summary(gaps)["request_mean_gap"] == 0.0
    per = {i: dict(check._summary([g]), tokens=len(g))
           for i, g in enumerate(gaps)}
    assert check.failed(per, {"request_mean_gap": 0.04}) == 0
    short = [torch.tensor([0.1, 0.0, 0.0]), torch.tensor([0.0, 0.3])]
    assert check._summary(short)["request_mean_gap"] == pytest.approx(
        0.1 / 3)
