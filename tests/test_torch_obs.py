"""The port's observability plane (``repro_torch.obs``): the twins of
tests/test_obs.py (trace recorder and inertness, SLO-violation
attribution, the metrics registry and its Prometheus rendering, counter
scraping, the served-mode ``/metrics`` endpoint), then the slice held to
the JAX package's exactly:

- the traced simulated fleet gives JAX's events, attribution and
  registry text;
- one reduced llama3.2-3b ``TorchEngine`` replica against one
  ``JaxEngine`` replica (2 layers, d_model 256, f32, the JAX engine's
  weights through ``bridge``) behind the fixed-clock shim of
  tests/test_torch_engine.py, each with its own package's recorder: the
  events are equal field for field, and so are ``attribute``,
  ``render_attribution_table`` and each replica's rendered registry once
  the JAX package's ``repro_engine_jit_cache_size`` gauge is stripped
  (JAX counts compiled programs; the eager port compiles none and
  exports no such gauge);
- the same for two reduced engines a side in an async fleet under a
  ``VirtualClock``, with ``install_tracer(fleet)`` and
  ``fleet.registry`` set. Each replica's events come from one thread at
  a time, so they are compared replica by replica (the ring interleaves
  the two worker threads' events in any order).

Every comparison is exact: the obs code is a copy and reads host
values only, and under the fixed clock every number it records comes
from the schedulers, which decide alike.
"""
import asyncio
import json
import math
import pathlib
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import obs as jobs  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs.paper_models import LLAMA3_8B as J_LLAMA3_8B  # noqa
from repro.core.qos import QoSSpec as JQoS  # noqa: E402
from repro.core.request import Request as JRequest  # noqa: E402
from repro.data import workloads as jworkloads  # noqa: E402
from repro.serving import schemes as jschemes  # noqa: E402
from repro.serving.asyncfleet import AsyncFleet as JAsyncFleet  # noqa: E402
from repro.serving.asyncfleet import VirtualClock as JVClock  # noqa: E402
from repro.serving.fleet.router import Router as JRouter  # noqa: E402
from repro.serving.kvcache import KVCacheConfig as JKVC  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.paper_models import LLAMA3_8B  # noqa: E402
from repro_torch.core.qos import QoSSpec  # noqa: E402
from repro_torch.core.request import Request  # noqa: E402
from repro_torch.data.workloads import (DATASETS, diurnal_arrivals,  # noqa
                                        make_requests, paper_workload)
from repro_torch.obs import (CAUSES, Attribution, MetricsRegistry,  # noqa
                             TraceRecorder, attribute, install_tracer,
                             render_attribution_table, validate_events)
from repro_torch.obs.attribution import annotate_report  # noqa: E402
from repro_torch.obs.scrape import scrape_fleet, scrape_replica  # noqa
from repro_torch.serving.asyncfleet import VirtualClock  # noqa: E402
from repro_torch.serving.kvcache import KVCacheConfig, KVHierarchy  # noqa
from repro_torch.serving.metrics import (MetricsReport,  # noqa: E402
                                         compute_metrics)
from repro_torch.serving.schemes import (make_async_torch_fleet,  # noqa
                                         make_fleet, make_replica,
                                         make_torch_replica,
                                         run_fleet_workload)

DATA = pathlib.Path(__file__).parent / "data"


# =====================================================================
# 1. metrics registry
# =====================================================================

def test_counter_inc_and_set_total_ratchet():
    reg = MetricsRegistry()
    c = reg.counter("repro_x_total", "x", ("replica",))
    c.inc(2, replica=0)
    c.inc(replica=0)
    assert c.value(replica=0) == 3.0
    # mirroring an external cumulative source only ratchets up
    c.set_total(10, replica=1)
    c.set_total(4, replica=1)
    assert c.value(replica=1) == 10.0
    with pytest.raises(AssertionError):
        c.inc(-1, replica=0)


def test_gauge_and_histogram():
    reg = MetricsRegistry()
    g = reg.gauge("repro_g", "g")
    g.set(5)
    g.dec(2)
    assert g.value() == 3.0
    h = reg.histogram("repro_h_seconds", "h", buckets=(0.1, 1.0))
    for v in (0.05, 0.5, 2.0, 0.5):
        h.observe(v)
    names = {n: v for n, ls, v in h.samples()}
    text = h.render()
    assert 'le="0.1"} 1' in text
    assert 'le="1"} 3' in text
    assert 'le="+Inf"} 4' in text
    assert "repro_h_seconds_count 4" in text
    assert abs(names["repro_h_seconds_sum"] - 3.05) < 1e-9


def test_registry_get_or_create_and_mismatch():
    reg = MetricsRegistry()
    a = reg.counter("repro_a_total", "a", ("replica",))
    assert reg.counter("repro_a_total", "a", ("replica",)) is a
    with pytest.raises(ValueError):
        reg.gauge("repro_a_total")           # kind mismatch
    with pytest.raises(ValueError):
        reg.counter("repro_a_total", "a", ("other",))  # label mismatch
    with pytest.raises(ValueError):
        a.inc(replica=0, extra=1)            # unexpected label


def test_prometheus_exposition_format():
    reg = MetricsRegistry()
    reg.counter("repro_b_total", "help text", ("q",)).inc(q="a b")
    reg.gauge("repro_a").set(1.5)
    text = reg.render()
    lines = text.splitlines()
    # sorted by metric name, HELP/TYPE headers precede samples
    assert lines[0] == "# HELP repro_a "
    assert lines[1] == "# TYPE repro_a gauge"
    assert lines[2] == "repro_a 1.5"
    assert "# TYPE repro_b_total counter" in lines
    assert 'repro_b_total{q="a b"} 1' in lines
    assert text.endswith("\n")


# =====================================================================
# 2. trace recorder
# =====================================================================

def test_ring_drops_oldest_and_counts():
    rec = TraceRecorder(capacity=3)
    for i in range(5):
        rec.emit("arrive", float(i), rid=i, rep=0)
    evs = rec.events()
    assert [e["rid"] for e in evs] == [2, 3, 4]
    assert rec.dropped == 2
    rec.clear()
    assert len(rec.events()) == 0 and rec.dropped == 0


def test_disabled_recorder_records_nothing():
    rec = TraceRecorder()
    rec.enabled = False
    rec.emit("arrive", 0.0, rid=1, rep=0)
    assert len(rec.events()) == 0


def test_validate_events_catches_schema_violations():
    good = [{"kind": "arrive", "t": 0.0, "rid": 1, "rep": 0}]
    assert validate_events(good) == []
    errs = validate_events([
        {"kind": "nope", "t": 0.0},
        {"kind": "iter", "t": 1.0, "rep": 0},       # missing fields
        {"kind": "finish", "rid": 1, "rep": 0},     # missing t
    ])
    assert len(errs) == 3


def test_jsonl_and_chrome_export(tmp_path):
    rec = TraceRecorder()
    rec.emit("arrive", 0.5, rid=1, rep=0)
    rec.emit("iter", 1.0, rep=0, t0=0.5, elapsed=0.5, predicted=0.4,
             prefill=[[1, 128]], decode=[], sched={"slack": float("inf")})
    rec.emit("migrate", 1.5, rid=1, src=0, dst=1, mkind="live",
             bytes=1e6, t_arr=1.7)
    p = tmp_path / "t.jsonl"
    assert rec.export_jsonl(str(p)) == 3
    evs = [json.loads(line) for line in p.read_text().splitlines()]
    assert validate_events(evs) == []
    assert evs[1]["sched"]["slack"] is None   # inf made JSON-safe
    c = tmp_path / "t.json"
    assert rec.export_chrome(str(c)) == 3
    doc = json.loads(c.read_text())
    tes = doc["traceEvents"]
    assert {e["ph"] for e in tes} == {"X", "i"}
    it = next(e for e in tes if e["name"].startswith("iter"))
    assert it["ts"] == pytest.approx(0.5e6) and \
        it["dur"] == pytest.approx(0.5e6)
    mig = next(e for e in tes if e["name"].startswith("migrate"))
    assert mig["name"] == "migrate:live rid=1"
    assert mig["dur"] == pytest.approx(0.2e6)


# =====================================================================
# 3. inertness: recording must not change any scheduling decision
# =====================================================================

def test_traced_solo_run_bit_identical_to_golden():
    """The golden solo scenario, re-run with the lifecycle tracer AND
    the plan-trace flag live, must still produce the recorded BatchPlan
    digest — recording is read-only."""
    from repro_torch.sim.trace import TraceRecorder as PlanRecorder
    from repro_torch.sim.trace import trace_digest
    ref = json.loads((DATA / "golden_traces.json").read_text())["solo"]
    reqs = paper_workload("azure_code", qps=5.0, duration=40.0, seed=7,
                          important_frac=0.7)
    rep = make_replica("niyama", LLAMA3_8B, seed=7, sim_noise=0.0)
    plans = PlanRecorder(rep.scheduler)
    rep.scheduler = plans
    obs = install_tracer(rep, TraceRecorder())
    rep.submit_all(reqs)
    rep.run(until=200.0)
    assert trace_digest(plans.lines) == ref["sha256"]
    assert len(obs.events()) > 0           # the tracer really was live
    assert validate_events(obs.events()) == []
    # the admission-verdict detail rode along without altering decisions
    sched = [e["sched"] for e in obs.events() if e["kind"] == "iter"]
    assert any(s is not None for s in sched)
    filled = next(s for s in sched if s is not None)
    assert {"alpha", "budget", "candidates", "losers"} <= set(filled)


def test_traced_fleet_run_bit_identical_to_golden():
    from repro_torch.sim.trace import TraceRecorder as PlanRecorder
    from repro_torch.sim.trace import trace_digest
    fix = json.loads((DATA / "golden_traces.json").read_text())
    rng = np.random.default_rng(3)
    arr = diurnal_arrivals(rng, 4.0, 12.0, period=20.0, duration=40.0)
    reqs = make_requests(DATASETS["azure_code"], arr, rng,
                         tier_probs=[0.6, 0.25, 0.15], important_frac=0.6)
    fleet = make_fleet(LLAMA3_8B, 2, policy="slack", seed=3, sim_noise=0.0)
    recs = []
    for rep in fleet.replicas:
        rec = PlanRecorder(rep.scheduler)
        rep.scheduler = rec
        recs.append(rec)
    obs = install_tracer(fleet, TraceRecorder())
    fleet.registry = MetricsRegistry()     # barrier scrapes also inert
    run_fleet_workload(fleet, reqs, until=200.0, duration=40.0)
    for i, rec in enumerate(recs):
        assert trace_digest(rec.lines) == fix[f"fleet_replica{i}"]["sha256"]
    assert validate_events(obs.events()) == []


def test_untraced_view_leaves_plan_trace_none():
    rep = make_replica("niyama", LLAMA3_8B, seed=0, sim_noise=0.0)
    reqs = paper_workload("azure_code", qps=2.0, duration=5.0, seed=0)
    rep.submit_all(reqs)
    rep.run(until=50.0)
    # no tracer -> the scheduler never built the verdict dict
    assert rep.tracer is None


# =====================================================================
# 4. attribution
# =====================================================================

def _traced_overloaded_fleet(qps=18.0, duration=60.0, seed=11):
    rng = np.random.default_rng(seed)
    arr = diurnal_arrivals(rng, 0.5 * qps, 1.5 * qps, period=40.0,
                           duration=duration)
    reqs = make_requests(DATASETS["azure_code"], arr, rng,
                         tier_probs=[0.6, 0.25, 0.15], important_frac=0.6)
    fleet = make_fleet(LLAMA3_8B, 2, policy="slack", seed=seed)
    rec = install_tracer(fleet, TraceRecorder())
    m = run_fleet_workload(fleet, reqs, until=duration + 60.0,
                           duration=duration)
    return fleet, rec, m


@pytest.fixture(scope="module")
def traced_fleet_run():
    return _traced_overloaded_fleet()


def test_explain_breakdown_sums_to_e2e(traced_fleet_run):
    """The exact-sum property: every finished request's cause durations
    (plus service) add up to its end-to-end latency."""
    fleet, rec, _ = traced_fleet_run
    att = Attribution(rec)
    fin = fleet.finished()
    assert len(fin) > 50
    for q in fin:
        ex = att.explain(q.rid)
        assert ex["finished"]
        total = sum(ex["breakdown"].values())
        assert math.isclose(total, ex["e2e"], rel_tol=1e-6, abs_tol=1e-6), \
            (q.rid, ex)
        assert ex["breakdown"]["service"] > 0.0


def test_attribution_coverage_at_capacity_edge(traced_fleet_run):
    """>= 95% of violated requests get a dominant cause (the acceptance
    gate bench_fleet also enforces)."""
    fleet, rec, m = traced_fleet_run
    summ = attribute(rec, fleet.all_requests())
    assert summ["n_violated"] > 10         # capacity edge really violated
    assert summ["coverage"] >= 0.95
    assert set(summ["causes"]) <= set(CAUSES) | {"service"}
    annotate_report(m, summ)
    assert m.attributed_frac == summ["coverage"]
    row = m.row()
    for cause, n in summ["causes"].items():
        assert row[f"cause_{cause}"] == n


def test_explain_unknown_rid():
    att = Attribution([])
    ex = att.explain(12345)
    assert ex["e2e"] == 0.0 and ex["dominant"] is None


def test_relegation_parking_dominates_parked_request():
    """Synthetic trace: a request parked 8s out of a 10s life must be
    dominated by relegation_parking."""
    evs = [
        {"kind": "arrive", "t": 0.0, "rid": 1, "rep": 0},
        {"kind": "iter", "t": 1.0, "rep": 0, "t0": 0.5, "elapsed": 0.5,
         "predicted": 0.5, "prefill": [[1, 256]], "decode": []},
        {"kind": "relegate", "t": 1.0, "rid": 1, "rep": 0},
        {"kind": "resume", "t": 9.0, "rid": 1, "rep": 0},
        {"kind": "iter", "t": 10.0, "rep": 0, "t0": 9.5, "elapsed": 0.5,
         "predicted": 0.4, "prefill": [], "decode": [1]},
        {"kind": "finish", "t": 10.0, "rid": 1, "rep": 0},
    ]
    ex = Attribution(evs).explain(1)
    assert ex["dominant"] == "relegation_parking"
    assert ex["breakdown"]["relegation_parking"] == pytest.approx(8.0)
    assert ex["breakdown"]["queue_wait"] == pytest.approx(0.5)
    assert ex["breakdown"]["service"] == pytest.approx(0.9)
    assert ex["breakdown"]["predictor_error"] == pytest.approx(0.1)
    assert sum(ex["breakdown"].values()) == pytest.approx(10.0)


def test_migration_pause_attribution():
    evs = [
        {"kind": "arrive", "t": 0.0, "rid": 7, "rep": 0},
        {"kind": "iter", "t": 1.0, "rep": 0, "t0": 0.0, "elapsed": 1.0,
         "predicted": 1.0, "prefill": [[7, 128]], "decode": []},
        {"kind": "migrate", "t": 1.0, "rid": 7, "src": 0, "dst": 1,
         "mkind": "live", "bytes": 2e6, "t_arr": 3.5},
        {"kind": "iter", "t": 4.0, "rep": 1, "t0": 3.5, "elapsed": 0.5,
         "predicted": 0.5, "prefill": [], "decode": [7]},
        {"kind": "finish", "t": 4.0, "rid": 7, "rep": 1},
    ]
    ex = Attribution(evs).explain(7)
    assert ex["breakdown"]["migration_pause"] == pytest.approx(2.5)
    assert ex["dominant"] == "migration_pause"
    assert sum(ex["breakdown"].values()) == pytest.approx(4.0)


# =====================================================================
# 5. scraping the serving stack
# =====================================================================

def test_scrape_mirrors_fleet_counters(traced_fleet_run):
    fleet, _, _ = traced_fleet_run
    reg = MetricsRegistry()
    scrape_fleet(reg, fleet)
    text = reg.render()
    assert reg.get("repro_fleet_replicas").value() == 2
    assert (reg.get("repro_iterations_total").value(replica=0)
            == fleet.replicas[0].iterations)
    assert (reg.get("repro_requests_finished_total").value()
            == len(fleet.finished()))
    assert reg.get("repro_fleet_barriers_total").value() == \
        fleet.report.ticks > 0
    assert "repro_queue_depth" in text and 'queue="prefill"' in text


def test_controller_scrapes_registry_at_barriers():
    reqs = paper_workload("azure_code", qps=6.0, duration=10.0, seed=5)
    fleet = make_fleet(LLAMA3_8B, 2, policy="slack", seed=5)
    fleet.registry = MetricsRegistry()
    run_fleet_workload(fleet, reqs, until=100.0, duration=10.0)
    # _observe ran scrape_fleet: counters mirrored without any caller code
    assert fleet.registry.get("repro_fleet_barriers_total").value() > 0
    total_iters = sum(r.iterations for r in fleet.replicas)
    mirrored = sum(
        fleet.registry.get("repro_iterations_total").value(replica=i)
        for i in range(2))
    assert mirrored <= total_iters   # last barrier may predate the drain


def test_hierarchy_swap_byte_counters():
    kv = KVHierarchy(64, block_size=16, bytes_per_block=1000,
                     cfg=KVCacheConfig(enable_swap=True, host_bytes=64000))
    kv.grow(1, 64)                      # 4 private blocks
    moved = kv.on_relegate(1, 64)
    assert moved == 64
    assert kv.swapped_out_bytes_total == 4000.0
    kv.swap_in(1)
    assert kv.swapped_in_bytes_total == 4000.0


def test_scrape_exports_reclaim_and_gather_bucket_counters():
    """The PR-8 data-plane counters cross the scrape boundary: SWA
    reclamation total and per-maxb paged-gather bucket hits (labelled by
    block-table width)."""
    from types import SimpleNamespace

    from repro_torch.core.kvpool import KVPool

    eng = SimpleNamespace(
        _swap_store={}, jit_compiles=3, buckets_seen=((0, 1, 2, 1),),
        prefill_rows=4, prefill_tokens=160, kv_blocks_reclaimed=5,
        gather_bucket_hits={1: 7, 4: 2})
    rep = SimpleNamespace(
        rid=0, kv=KVPool(num_blocks=8, block_size=32), backend=eng,
        prefill_queue=[], decode_queue=[], relegated_queue=[],
        iterations=9, busy_time=1.0, backpressure_defers=0)
    reg = MetricsRegistry()
    scrape_replica(reg, rep)
    assert reg.get("repro_kv_blocks_reclaimed_total").value(replica=0) == 5
    hits = reg.get("repro_paged_gather_bucket_hits_total")
    assert hits.value(replica=0, maxb="1") == 7
    assert hits.value(replica=0, maxb="4") == 2
    text = reg.render()
    assert 'maxb="4"' in text


# =====================================================================
# 6. MetricsReport: fleet-key namespacing + attribution fields
# =====================================================================

def test_fleet_row_keys_cannot_shadow_top_level_metrics():
    """Regression: a FleetReport-side key equal to a top-level metric
    name must land under fleet_*, not overwrite the request metric."""
    class CollidingReport:
        def row(self):
            return {"goodput": 999.0, "fleet_ticks": 3}
    m = MetricsReport(n=4, goodput=5.0)
    m.fleet = CollidingReport()
    row = m.row()
    assert row["goodput"] == 5.0           # top-level survives
    assert row["fleet_goodput"] == 999.0   # fleet value namespaced
    assert row["fleet_ticks"] == 3         # already-prefixed key untouched


def test_compute_metrics_row_includes_fleet_prefixed_keys():
    from repro_torch.serving.fleet.telemetry import FleetReport
    m = compute_metrics([], 1.0, fleet=FleetReport(n_replicas=2))
    row = m.row()
    assert all(k.startswith("fleet_") or not k.startswith("fleet")
               for k in row)
    assert row["fleet_replicas"] == 2


# =====================================================================
# 7. served-mode wall metrics + /metrics endpoint
# =====================================================================

def test_wall_metrics_percentiles():
    from repro_torch.serving.asyncfleet.server import AsyncServer, _pct

    class FakeClock:
        def now(self):
            return 0.0

    class FakeFleet:
        clock = FakeClock()
        registry = None
    srv = AsyncServer(FakeFleet())
    srv._submit_wall = {1: 0.0, 2: 10.0}
    srv._token_walls = {1: [1.0, 1.1, 1.3], 2: [10.5, 10.6]}
    wm = srv.wall_metrics()
    assert wm["n_requests"] == 2 and wm["n_tokens"] == 5
    assert wm["ttft_p50"] == pytest.approx(0.5)   # [0.5, 1.0] median-ish
    assert wm["tbt_p99"] == pytest.approx(0.2)
    assert wm["tbt_mean"] == pytest.approx((0.1 + 0.2 + 0.1) / 3)
    assert _pct([], 50) == 0.0
    assert srv.token_walls(1) == [1.0, 1.1, 1.3]


def test_metrics_http_endpoint(traced_fleet_run):
    """GET /metrics on the AsyncServer listener returns Prometheus text
    with the migrated counters; other paths 404."""
    from repro_torch.serving.asyncfleet.server import AsyncServer
    fleet, _, _ = traced_fleet_run

    async def go():
        srv = AsyncServer(fleet, metrics_port=0)
        await srv._start_metrics_server()
        host, port = srv.metrics_addr

        async def fetch(path):
            r, w = await asyncio.open_connection(host, port)
            w.write(f"GET {path} HTTP/1.1\r\nHost: t\r\n\r\n".encode())
            await w.drain()
            data = await r.read()
            w.close()
            return data

        ok = await fetch("/metrics")
        missing = await fetch("/nope")
        srv._http_server.close()
        await srv._http_server.wait_closed()
        return ok, missing

    ok, missing = asyncio.run(go())
    text = ok.decode()
    assert "200 OK" in text
    assert "version=0.0.4" in text
    for family in ("repro_fleet_replicas", "repro_iterations_total",
                   "repro_backpressure_defers_total", "repro_kv_blocks_free",
                   "repro_wall_latency_seconds"):
        assert family in text, family
    assert b"404" in missing


# =====================================================================
# 8. the slice against the JAX package, exactly
# =====================================================================

_JIT_LINE = "repro_engine_jit_cache_size"


def _no_jit(text: str) -> str:
    """The JAX package's rendered registry without its jit-cache gauge's
    lines, which the port does not export."""
    return "".join(l for l in text.splitlines(keepends=True)
                   if _JIT_LINE not in l)


def _per_replica(events, n: int) -> list:
    """Each replica's events in emission order, then the migrations."""
    out = [[e for e in events if e.get("rep") == i] for i in range(n)]
    out.append([e for e in events if e["kind"] == "migrate"])
    return out


def test_traced_sim_fleet_equals_jax(traced_fleet_run):
    """The overloaded simulated fleet of ``traced_fleet_run`` on both
    packages: the same events, attribution, table and registry text."""
    fleet, rec, _ = traced_fleet_run
    rng = np.random.default_rng(11)
    arr = jworkloads.diurnal_arrivals(rng, 9.0, 27.0, period=40.0,
                                      duration=60.0)
    reqs = jworkloads.make_requests(
        jworkloads.DATASETS["azure_code"], arr, rng,
        tier_probs=[0.6, 0.25, 0.15], important_frac=0.6)
    jfleet = jschemes.make_fleet(J_LLAMA3_8B, 2, policy="slack", seed=11)
    jrec = jobs.install_tracer(jfleet, jobs.TraceRecorder())
    jschemes.run_fleet_workload(jfleet, reqs, until=120.0, duration=60.0)
    assert len(rec.events()) > 1000
    assert rec.events() == jrec.events()
    got = attribute(rec, fleet.all_requests())
    want = jobs.attribute(jrec, jfleet.all_requests())
    assert got == want
    assert render_attribution_table(got) == \
        jobs.render_attribution_table(want)
    reg, jreg = MetricsRegistry(), jobs.MetricsRegistry()
    scrape_fleet(reg, fleet)
    jobs.scrape_fleet(jreg, jfleet)
    assert reg.render() == jreg.render()


class _FixedClock:
    """The fixed-clock shim of tests/test_torch_engine.py: a constant
    iteration time, so both packages' schedulers make the same decisions
    whatever the engines' speed."""

    def __init__(self, inner):
        self.inner = inner

    def execute(self, plan, now):
        self.inner.execute(plan, now)
        return 0.05

    def __getattr__(self, name):
        return getattr(self.inner, name)


def _slo_requests(req_cls, qos_cls, n=6):
    """``n`` requests through 2 slots under SLOs that the 0.05 s
    iterations of the fixed clock break: queue waits miss the 0.25 s
    TTFT and the batch tier's 1.5 s TTLT, so attribution has work."""
    chat = qos_cls("chat", interactive=True, ttft_slo=0.25, tbt_slo=0.06)
    bulk = qos_cls("bulk", interactive=False, ttlt_slo=1.5)
    return [req_cls(rid=i, arrival=0.05 * i, prompt_len=20 + 10 * i,
                    decode_len=6 + 2 * (i % 3),
                    qos=chat if i % 2 == 0 else bulk,
                    app_id="chat" if i % 2 == 0 else "bulk",
                    important=i % 3 != 0)
            for i in range(n)]


def _configs():
    jc = jax_get_config("llama3.2-3b").reduced(num_layers=2, d_model=256)
    tc = get_config("llama3.2-3b").reduced(num_layers=2, d_model=256)
    return jc, tc


def _check_same_obs(rec, jrec, reqs, jreqs, reg, jreg):
    got = attribute(rec, reqs)
    want = jobs.attribute(jrec, jreqs)
    assert got == want
    assert got["n_violated"] > 0          # the SLOs really were missed
    assert render_attribution_table(got) == \
        jobs.render_attribution_table(want)
    text, jtext = reg.render(), jreg.render()
    assert _JIT_LINE in jtext and _JIT_LINE not in text
    assert text == _no_jit(jtext)
    assert reg.get(_JIT_LINE) is None     # eager: no programs to count


def test_traced_engine_replica_equals_jax():
    jc, tc = _configs()
    kw = dict(n_slots=2, max_len=128, block_size=16, quantum=16, seed=5)
    jrep = jschemes.make_jax_replica("niyama", jc, backend_wrap=_FixedClock,
                                     **kw)
    sd = bridge.params_from_numpy(
        jax.tree.map(np.asarray, jrep.backend.inner.params))
    trep = make_torch_replica("niyama", tc, device="cpu", params=sd,
                              backend_wrap=_FixedClock, **kw)
    jrec = jobs.install_tracer(jrep, jobs.TraceRecorder())
    rec = install_tracer(trep, TraceRecorder())
    jrep.submit_all(_slo_requests(JRequest, JQoS))
    trep.submit_all(_slo_requests(Request, QoSSpec))
    jrep.run()
    trep.run()
    assert len(trep.finished) == len(jrep.finished) == 6
    evs = rec.events()
    assert validate_events(evs) == []
    assert {"arrive", "enqueue", "iter", "finish"} <= {e["kind"]
                                                       for e in evs}
    assert any(e["kind"] == "iter" and e["sched"] is not None for e in evs)
    assert evs == jrec.events()
    assert trep.backend.inner.generated == jrep.backend.inner.generated
    reg, jreg = MetricsRegistry(), jobs.MetricsRegistry()
    scrape_replica(reg, trep)
    jobs.scrape_replica(jreg, jrep)
    assert reg.get("repro_engine_prefill_tokens_total").value(replica=0) \
        == trep.backend.inner.prefill_tokens > 0
    _check_same_obs(rec, jrec, trep.all_requests(), jrep.all_requests(),
                    reg, jreg)


FLEET = dict(n_slots=2, max_len=128, block_size=32, quantum=16, seed=7)


def _jax_fleet(jc):
    """The JAX twin of ``make_async_torch_fleet`` with the shim and a
    virtual clock, as tests/test_torch_asyncfleet.py builds it."""
    reps = []
    for i in range(2):
        rep = jschemes.make_jax_replica(
            "niyama", jc, kv_cfg=JKVC(enable_prefix=True, enable_swap=True,
                                      host_bytes=1e9),
            backend_wrap=_FixedClock, **FLEET)
        rep.rid = i
        reps.append(rep)
    return JAsyncFleet(reps, JRouter(reps, policy="slack"), clock=JVClock(),
                       live_migrate=True)


def test_traced_async_fleet_equals_jax():
    jc, tc = _configs()
    jf = _jax_fleet(jc)
    sd = bridge.params_from_numpy(jax.tree.map(
        np.asarray, jf.engine_of(jf.replicas[0]).params))
    tf = make_async_torch_fleet(tc, 2, device="cpu", params=sd,
                                backend_wrap=_FixedClock,
                                clock=VirtualClock(), **FLEET)
    jrec = jobs.install_tracer(jf, jobs.TraceRecorder())
    rec = install_tracer(tf, TraceRecorder())
    jf.registry = jobs.MetricsRegistry()
    tf.registry = MetricsRegistry()
    try:
        jf.submit(_slo_requests(JRequest, JQoS, 8))
        tf.submit(_slo_requests(Request, QoSSpec, 8))
        jf.run(until=60.0)
        tf.run(until=60.0)
    finally:
        jf.close()
        tf.close()
    assert len(tf.finished()) == len(jf.finished()) == 8
    evs = rec.events()
    assert validate_events(evs) == []
    assert _per_replica(evs, 2) == _per_replica(jrec.events(), 2)
    assert sorted(map(str, evs)) == sorted(map(str, jrec.events()))
    assert all(e.get("rep", 0) in (0, 1) for e in evs)
    assert {e["rep"] for e in evs if e["kind"] == "iter"} == {0, 1}
    # the barrier scrapes ran (the registry holds the last barrier's)
    assert tf.registry.get("repro_fleet_barriers_total").value() > 0
    _check_same_obs(rec, jrec, tf.all_requests(), jf.all_requests(),
                    tf.registry, jf.registry)
    reg, jreg = MetricsRegistry(), jobs.MetricsRegistry()
    scrape_fleet(reg, tf)
    jobs.scrape_fleet(jreg, jf)
    assert reg.render() == _no_jit(jreg.render())
    assert reg.get("repro_requests_finished_total").value() == 8


# =====================================================================
# 9. the serve script's flags and the scrape under threads
# =====================================================================

def test_serve_trace_flags(tmp_path, capsys):
    from repro_torch.launch import serve
    out, chrome = tmp_path / "t.jsonl", tmp_path / "t.json"
    rep = serve.main(["--device", "cpu", "--reduced", "--n-requests", "4",
                      "--slots", "2", "--max-len", "128", "--trace-out",
                      str(out), "--trace-chrome", str(chrome)])
    assert rep.tracer is not None and len(rep.finished) == 4
    evs = [json.loads(line) for line in out.read_text().splitlines()]
    assert len(evs) == len(rep.tracer.events()) > 0
    assert validate_events(evs) == []
    att = Attribution(rep.tracer)
    for q in rep.finished:
        ex = att.explain(q.rid)
        assert math.isclose(sum(ex["breakdown"].values()), ex["e2e"],
                            rel_tol=0.0, abs_tol=1e-9)
    assert json.loads(chrome.read_text())["traceEvents"]
    text = capsys.readouterr().out
    assert f"trace: {len(evs)} events" in text
    assert "SLO-violation attribution" in text
    # no flag: no recorder, the hooks stay inert
    assert serve.main(["--backend", "sim", "--duration", "5"]).tracer is None


def test_serve_fleet_metrics_port_and_trace(tmp_path, capsys):
    from repro_torch.launch import serve
    out = tmp_path / "f.jsonl"
    fleet = serve.main(["--fleet", "2", "--device", "cpu", "--reduced",
                        "--n-requests", "4", "--slots", "2", "--max-len",
                        "128", "--metrics-port", "0", "--trace-out",
                        str(out)])
    text = capsys.readouterr().out
    assert "metrics: http://127.0.0.1:" in text
    assert fleet.tracer is not None and fleet.registry is not None
    assert fleet.registry.get("repro_fleet_barriers_total").value() > 0
    assert validate_events(fleet.tracer.events()) == []
    assert sum(1 for e in fleet.tracer.events() if e["kind"] == "finish") \
        == 4


def test_scrape_snapshots_bucket_hits_under_a_writer():
    """A worker thread adding page-window keys while the scrape sorts
    them: the scrape reads a ``dict(...)`` snapshot, so it never sees the
    dict change size mid-iteration."""
    from types import SimpleNamespace

    from repro_torch.core.kvpool import KVPool

    eng = SimpleNamespace(
        _swap_store={}, jit_compiles=0, buckets_seen=(), prefill_rows=0,
        prefill_tokens=0, gather_bucket_hits={})
    rep = SimpleNamespace(
        rid=0, kv=KVPool(num_blocks=8, block_size=32), backend=eng,
        prefill_queue=[], decode_queue=[], relegated_queue=[],
        iterations=0, busy_time=0.0, backpressure_defers=0)
    stop = threading.Event()

    def writer():
        k = 0
        while not stop.is_set():
            k += 1
            eng.gather_bucket_hits[k] = 1
            if k % 512 == 0:
                eng.gather_bucket_hits.clear()

    t = threading.Thread(target=writer)
    t.start()
    try:
        reg = MetricsRegistry()
        for _ in range(300):
            scrape_replica(reg, rep)
    finally:
        stop.set()
        t.join()
    assert reg.get("repro_kv_blocks_free").value(replica=0) == 8
