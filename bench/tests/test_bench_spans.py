"""The reduction of the program's spans (``nbench/spans.py``) on
synthetic profiler events, in the style of ``test_bench_units.py``, and
a tiny traced run of ``trace_spans.py`` on the CPU."""
import types

import pytest

from nbench import profile
from nbench.spans import host_readings, innermost, reduce_program

SEED = 2 ** 31 + 11


def _ev(name, a, b, device=False, dev_us=0.0):
    return types.SimpleNamespace(
        name=name, time_range=types.SimpleNamespace(start=a, end=b),
        device_type="DeviceType.CUDA" if device else "DeviceType.CPU",
        device_time_total=dev_us)


def _step(t0):
    """One replica step from ``t0``, 1000 us long, as the program's spans
    nest on the host (six deep under ``engine.launch``, with 48 closed
    ``moe.*`` and ``engine.host_read`` children), its kernels and the
    launches that started them."""
    ev = [_ev("bench.step", t0, t0 + 1000),
          _ev("replica.admit", t0, t0 + 10),
          _ev("replica.schedule", t0 + 10, t0 + 60),
          _ev("bench.schedule", t0 + 20, t0 + 50),
          _ev("replica.execute", t0 + 60, t0 + 960),
          _ev("engine.pack", t0 + 70, t0 + 100),
          _ev("engine.launch", t0 + 100, t0 + 700),
          _ev("engine.sync", t0 + 700, t0 + 900),
          _ev("engine.post", t0 + 900, t0 + 950),
          _ev("replica.apply", t0 + 960, t0 + 990)]
    for i in range(24):
        a = t0 + 110 + 20 * i
        ev += [_ev("moe.router", a, a + 5), _ev("moe.experts", a + 5, a + 9),
               _ev("engine.host_read", a + 9, a + 12),
               _ev("moe.combine", a + 12, a + 15),
               _ev("cudaLaunchKernel", a + 1, a + 2)]
    # the forward's kernels run 200-300 and 600-850 us into the step
    ev += [_ev("gemm", t0 + 200, t0 + 300, True),
           _ev("gemm", t0 + 600, t0 + 850, True),
           _ev("Memcpy DtoH (Device -> Pageable)", t0 + 850, t0 + 860,
               True)]
    return ev


def _trace(n=2):
    ev = [_ev(profile.SPAN, 0, 1000 * n + 100)]
    for i in range(n):
        ev += _step(1000 * i)
    # a launch in engine.pack and one outside every span are not counted
    ev += [_ev("cudaLaunchKernel", 80, 81),
           _ev("cuLaunchKernel", 1050, 1051)]
    return ev


def _overlap(iv, gaps):
    return sum(max(0, min(b, d) - max(a, c))
               for a, b in iv for c, d in gaps)


def test_idle_goes_to_the_innermost_span_at_any_depth():
    t = reduce_program(_trace())
    # the host reads' idle time in the forward's gaps (100-200, 300-600)
    reads = _overlap([(110 + 20 * i + 9, 110 + 20 * i + 12)
                      for i in range(24)], [(100, 200), (300, 600)])
    assert 0 < reads < 72
    per = {  # idle us a step, by innermost span
        "replica.admit": 10, "replica.schedule": 20, "bench.schedule": 30,
        "replica.execute": 10 + 10, "engine.pack": 30,
        # the moe.* spans' own time too
        "engine.launch": 400 - reads, "engine.host_read": reads,
        "engine.sync": 40, "engine.post": 50, "replica.apply": 30,
        "bench.step": 10}
    for k, us in per.items():
        assert t.idle_by_span[k] == pytest.approx(2 * us * 1e-6), k
    # after the last step: outside every span
    assert t.idle_by_span["bench.loop"] == pytest.approx(100e-6)
    assert not any(k.startswith("moe.") for k in t.idle_by_span)
    assert sum(t.idle_by_span.values()) == pytest.approx(t.idle_s)
    assert list(t.idle_by_span)[0] == "engine.launch"
    assert t.idle_launch_pct == pytest.approx(
        100 * 2 * (400 - reads) / 2100)


def test_the_last_four_opened_rule_misses_what_the_sweep_finds():
    """``profile._by_host``'s rule (the innermost of the last four spans
    opened) over the program's spans: the closed children under
    ``engine.launch`` fill its window, and the idle time in the launch
    span goes elsewhere. The sweep puts it on ``engine.launch`` and the
    host reads inside it."""
    ev = _trace(1)
    host = sorted((e.time_range.start, e.time_range.end, e.name)
                  for e in ev if e.name.startswith(("replica.", "engine."))
                  and e.device_type.endswith("CPU"))
    gaps = [(300, 600)]
    old = profile._by_host(gaps, host, 0, 1100)
    assert "engine.launch" not in old
    segs = innermost(host, 0, 1100)
    new = {n: sum(min(b, 600) - max(a, 300) for a, b, m in segs
                  if m == n and min(b, 600) > max(a, 300))
           for n in {m for _, _, m in segs}}
    new = {k: v for k, v in new.items() if v}
    assert set(new) == {"engine.launch", "engine.host_read"}
    assert sum(new.values()) == 300 and new["engine.launch"] > 200


def test_a_gap_outside_every_program_span_goes_to_bench_step():
    ev = [_ev(profile.SPAN, 0, 500), _ev("bench.step", 0, 400),
          _ev("replica.execute", 100, 300), _ev("engine.launch", 150, 250),
          _ev("gemm", 150, 250, True)]
    t = reduce_program(ev)
    assert t.idle_by_span == pytest.approx(
        {"bench.step": 200e-6, "replica.execute": 100e-6,
         "bench.loop": 100e-6})


def test_only_the_launches_inside_engine_launch_count():
    t = reduce_program(_trace())
    assert t.launches == 48 and t.launch_spans == 2
    assert t.launches_per_step == 24
    assert t.launches_by_name == {"cudaLaunchKernel": 48}
    assert t.kernel_events == 4           # the copies are no kernels


def test_the_program_spans_leave_reduce_events_as_it_was():
    """The harness's own reduction of the existing test events is the
    same with the program's spans, and their copies on the device
    timeline, added to them: its idle split, kernels and busy seconds;
    ``spans`` gains the new names alone."""
    base = [_ev(profile.SPAN, 0, 1000),
            _ev("bench.step", 0, 600), _ev("bench.schedule", 10, 60),
            _ev("bench.wait", 600, 1000), _ev("moe.experts", 100, 200,
                                              dev_us=150.0),
            _ev("gemm", 100, 300, True), _ev("gemm", 250, 400, True),
            _ev("paged_decode_partial_kernel", 500, 550, True),
            _ev("late", 990, 1200, True),
            _ev("bench.step", 0, 600, True), _ev("moe.experts", 100, 200,
                                                 True)]
    program = [_ev("replica.schedule", 5, 65),
               _ev("replica.execute", 70, 590),
               _ev("engine.launch", 90, 420, dev_us=360.0),
               _ev("engine.host_read", 150, 160),
               _ev("engine.sync", 420, 560),
               _ev("engine.launch", 90, 420, True),
               _ev("replica.execute", 70, 590, True)]
    a = profile.reduce_events(base, steps=3)
    b = profile.reduce_events(base + program, steps=3)
    assert (b.idle, b.kernels, b.busy_s, b.window_s) == \
        (a.idle, a.kernels, a.busy_s, a.window_s)
    assert {k: v for k, v in b.spans.items() if k in a.spans} == a.spans
    assert set(b.spans) - set(a.spans) <= {
        "replica.schedule", "replica.execute", "engine.launch",
        "engine.host_read", "engine.sync"}


def test_host_readings_of_the_per_step_deltas():
    d = [{"replica.admit": (1, 0.001), "replica.schedule": (1, 0.002)},
         {"replica.admit": (1, 0.001), "replica.schedule": (1, 0.001),
          "engine.pack": (1, 0.004), "engine.launch": (1, 0.05),
          "engine.host_read": (96, 0.01), "engine.sync": (1, 0.03),
          "engine.post": (1, 0.002), "replica.apply": (1, 0.001)}]
    h = host_readings(d)
    assert h["engine_launch_ms"] == pytest.approx(1e3 * 0.04 / 2)
    assert h["host_serial_ms"] == pytest.approx(1e3 * 0.012 / 2)
    assert h["host_reads_per_step"] == 48
    assert h["engine_spans_ms"] == pytest.approx(86.0)
    assert host_readings(d[:1]) == dict.fromkeys(h)


def test_a_tiny_traced_run_reads_the_program_spans(tiny_root):
    """The tool's traced run of a tiny cell on the CPU: the host readings
    of the span table, an ``idle_by_span`` that sums to the traced span's
    idle time (all of it on the CPU), and nothing read where the trace
    holds no launch."""
    import trace_spans
    from repro_torch.obs import spans

    res = trace_spans.serve(tiny_root, "tiny.moe", SEED, 2.0, True, True,
                            "cpu")
    assert not spans._ON
    h = res["host"]
    assert h["engine_launch_ms"] > 0 and h["host_serial_ms"] > 0
    assert h["host_reads_per_step"] > 0
    assert h["engine_spans_ms"] == pytest.approx(h["engine_ms"], rel=0.05)
    p = res["program_trace"]
    assert p["idle_by_span_sum"] == pytest.approx(p["idle_s"], rel=1e-9)
    assert p["idle_s"] == pytest.approx(p["window_s"] - p["busy_s"])
    assert "engine.launch" in res["idle_by_span"]
    assert p["launches_per_step"] is None and p["idle_launch_pct"] is None
    assert "device_idle_pct" in res["metrics"]
    assert all(v >= 0 for v in res["reduce_s"].values())
