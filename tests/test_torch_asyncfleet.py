"""The port's async fleet runtime: ``AsyncFleet`` on worker threads over
``TorchEngine``s, held to the JAX package's over ``JaxEngine``s.

1. Virtual mode (worker threads, ``VirtualClock``) reproduces the golden
   BatchPlan digests of the lockstep fleet (the twin of
   tests/test_asyncfleet.py's first oracle).
2. Two reduced llama3.2-3b engines a fleet, in f32 on the CPU, on the
   JAX engines' weights (``bridge.params_from_numpy``), behind the
   fixed-clock shim of tests/test_torch_engine.py: the torch fleet makes
   the same plans on every replica and streams the same tokens as the
   fleet of two ``JaxEngine``s, through one live move of a decoding
   request and through one relegation-offload transfer mid-prefill;
   every stream also equals the port's own offline greedy decode. The
   move is forced between two ``run(until=...)`` calls of the virtual
   fleet (``_force_live_move`` at the barrier the first run stopped on),
   so it lands at the same virtual time on both sides; nothing here
   reads the wall clock.
3. Payloads: a torch payload counts the bytes of the JAX payload of the
   same request; a bf16-page engine and an int8-page engine refuse each
   other's payloads.
4. Wall mode: ``make_async_torch_fleet(device="cpu")`` behind
   ``AsyncServer``, and ``serve --fleet 2``, finish every request
   exactly once; only outcomes that do not depend on timing are checked.
5. The kernel wrappers' counts lose nothing when two threads call them,
   and the kernel libraries are built and loaded once under a lock.
"""
import asyncio
import json
import pathlib
import sys
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core.qos import QoSSpec as JQoS  # noqa: E402
from repro.core.request import Phase as JPhase  # noqa: E402
from repro.core.request import Request as JRequest  # noqa: E402
from repro.core.scheduler import BatchPlan as JPlan  # noqa: E402
from repro.serving.asyncfleet import AsyncFleet as JAsyncFleet  # noqa: E402
from repro.serving.asyncfleet import VirtualClock as JVClock  # noqa: E402
from repro.serving.asyncfleet.transfer import \
    payload_nbytes as jnbytes  # noqa: E402
from repro.serving.fleet.router import Router as JRouter  # noqa: E402
from repro.serving.kvcache import KVCacheConfig as JKVC  # noqa: E402
from repro.serving.schemes import make_jax_replica  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.paper_models import LLAMA3_8B  # noqa: E402
from repro_torch.core.qos import QoSSpec as TQoS  # noqa: E402
from repro_torch.core.request import Phase as TPhase  # noqa: E402
from repro_torch.core.request import Request as TRequest  # noqa: E402
from repro_torch.core.scheduler import BatchPlan as TPlan  # noqa: E402
from repro_torch.data.workloads import (DATASETS, diurnal_arrivals,  # noqa
                                        make_requests)
from repro_torch.engine.torch_backend import TorchEngine  # noqa: E402
from repro_torch.kernels import build, ops  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.serving.asyncfleet import (AsyncFleet, AsyncServer,  # noqa
                                            VirtualClock, WallClock)
from repro_torch.serving.asyncfleet.transfer import payload_nbytes  # noqa
from repro_torch.serving.schemes import (make_async_torch_fleet,  # noqa
                                         make_fleet, run_fleet_workload)
from repro_torch.sim.trace import TraceRecorder, trace_digest  # noqa: E402

DATA = pathlib.Path(__file__).parent / "data"
# the fleet of tests/test_asyncfleet.py: 2 slots of 128 tokens an engine,
# 32-token blocks, quantum 16, engine seed 7 (weights and prompts)
FLEET = dict(n_slots=2, max_len=128, block_size=32, quantum=16, seed=7)


class _FixedClock:
    """The fixed-clock shim of tests/test_torch_engine.py: a constant
    iteration time, so both packages' schedulers make the same decisions
    whatever the engines' speed; records each plan as ((rid, chunk),
    ...), (decode rids)."""

    def __init__(self, inner):
        self.inner = inner
        self.plans = []

    def execute(self, plan, now):
        self.plans.append((tuple((r.rid, c) for r, c in plan.prefill),
                           tuple(r.rid for r in plan.decode)))
        self.inner.execute(plan, now)
        return 0.05

    def __getattr__(self, name):
        return getattr(self.inner, name)


def _configs():
    jc = jax_get_config("llama3.2-3b").reduced(num_layers=2, d_model=128)
    tc = get_config("llama3.2-3b").reduced(num_layers=2, d_model=128)
    return jc, tc


def _jax_fleet(jc, policy="slack"):
    """The JAX package's twin of ``make_async_jax_fleet`` with the shim
    and a virtual clock (its factory takes no ``backend_wrap``)."""
    reps = []
    for i in range(2):
        rep = make_jax_replica(
            "niyama", jc, kv_cfg=JKVC(enable_prefix=True, enable_swap=True,
                                      host_bytes=1e9),
            backend_wrap=_FixedClock, **FLEET)
        rep.rid = i
        reps.append(rep)
    return JAsyncFleet(reps, JRouter(reps, policy=policy), clock=JVClock(),
                       live_migrate=True)


def _fleets(policy="slack"):
    """(JAX fleet, torch fleet on the JAX engines' weights, torch cfg,
    the weights as a state_dict)."""
    jc, tc = _configs()
    jf = _jax_fleet(jc, policy)
    sd = bridge.params_from_numpy(jax.tree.map(
        np.asarray, jf.engine_of(jf.replicas[0]).params))
    tf = make_async_torch_fleet(tc, 2, policy=policy, device="cpu",
                                params=sd, backend_wrap=_FixedClock,
                                clock=VirtualClock(), **FLEET)
    return jf, tf, tc, sd


def offline_greedy(tc, sd, rid, prompt_len, n_tokens):
    """The port's own oracle: one engine, one request, its whole prompt in
    one chunk then greedy decode, on the same weights and prompt."""
    eng = TorchEngine(tc, n_slots=1, max_len=FLEET["max_len"],
                      quantum=FLEET["quantum"], seed=FLEET["seed"],
                      block_size=FLEET["block_size"], params=sd,
                      device="cpu")
    qos = TQoS("q", interactive=True, ttft_slo=1e6, tbt_slo=1e6)
    r = TRequest(rid=rid, arrival=0.0, prompt_len=prompt_len,
                 decode_len=n_tokens, qos=qos)
    eng.on_admit(r)
    eng.execute(TPlan(prefill=[(r, prompt_len)]), 0.0)
    r.prefilled = prompt_len
    for _ in range(n_tokens - 1):
        eng.execute(TPlan(decode=[r]), 0.0)
    return eng.generated[rid]


def _requests(req_cls, qos_cls):
    qos = qos_cls("q", interactive=True, ttft_slo=1e6, tbt_slo=1e6)
    return [req_cls(rid=i, arrival=0.0, prompt_len=24 + 7 * i,
                    decode_len=30 if i == 0 else 6, qos=qos)
            for i in range(5)]


# =====================================================================
# 1. virtual mode == the lockstep golden traces
# =====================================================================

def test_virtual_mode_reproduces_golden_fleet_traces():
    rng = np.random.default_rng(3)
    arr = diurnal_arrivals(rng, 4.0, 12.0, period=20.0, duration=40.0)
    reqs = make_requests(DATASETS["azure_code"], arr, rng,
                         tier_probs=[0.6, 0.25, 0.15], important_frac=0.6)
    fleet = make_fleet(LLAMA3_8B, 2, policy="slack", seed=3, sim_noise=0.0,
                       controller_cls=AsyncFleet, clock=VirtualClock())
    recs = []
    for rep in fleet.replicas:
        rec = TraceRecorder(rep.scheduler)
        rep.scheduler = rec
        recs.append(rec)
    try:
        run_fleet_workload(fleet, reqs, until=200.0, duration=40.0)
    finally:
        fleet.close()
    fix = json.loads((DATA / "golden_traces.json").read_text())
    assert [trace_digest(r.lines) for r in recs] == \
        [fix["fleet_replica0"]["sha256"], fix["fleet_replica1"]["sha256"]]
    assert fleet.report.migrations > 0


# =====================================================================
# 2. real engines: the torch fleet serves as the JAX fleet does
# =====================================================================

def _live_move(fleet, reqs):
    """Serve ``reqs`` on the virtual fleet, moving decoding rid 0 to the
    other replica at the 0.3 s barrier (it decodes beside rid 4 there,
    the other replica is idle); returns the move's success and the
    replica it left."""
    fleet.submit(reqs)
    fleet.run(until=0.3)
    src = next(i for i, rep in enumerate(fleet.replicas)
               if any(r.rid == 0 for r in rep.decode_queue))
    snaps = [fleet._snapshot(i) for i in range(len(fleet.replicas))]
    moved = fleet._force_live_move(0, 1 - src, fleet._t, snaps)
    fleet.run(until=60.0)
    return moved, src


def _offload(fleet, req, plan_cls, phase):
    """A request relegated mid-prefill on replica 0 (its 64 prefilled
    tokens parked in the engine's swap store) crosses to replica 1's
    engine through the runtime's detach / receive hooks and finishes
    there (tests/test_asyncfleet.py's offload scenario, by hand);
    returns the payload's bytes."""
    src, dst = fleet.replicas
    se = fleet.engine_of(src)
    src.kv.attach(req)
    se.on_admit(req)
    se.execute(plan_cls(prefill=[(req, 64)]), 0.0)
    req.prefilled = 64
    req.phase = phase.RELEGATED
    req.was_relegated = True
    req.relegated_at = src.now
    req.prefilled = src.kv.on_relegate(req.rid, 64)
    src.relegated_queue.append(req)
    se.on_release(req)
    src.state_version += 1
    assert req.prefilled == 64 and src.kv.swapped_tokens(req.rid) == 64
    assert fleet._transfer_ok(src, dst, req)
    tokens = fleet._detach_swapped(src, req)
    assert tokens == 64 and req.rid not in se._swap_store
    nbytes = payload_nbytes(fleet._wire[req.rid])
    req.phase = phase.QUEUED
    assert fleet._receive_swapped(dst, req, 0.0, tokens)
    assert req.prefilled == 64           # resumes, no recompute
    dst.run(until=60.0)
    assert req.phase is phase.FINISHED
    return nbytes


@pytest.mark.parametrize("transfer", ["live", "offload"])
def test_torch_fleet_serves_as_the_jax_fleet_through_a_transfer(transfer):
    """Both fleets run the same scenario; every replica's plans are equal,
    every stream is equal (f32 on the CPU: exactly) and has all its
    tokens, the transfer really moved engine state, and each stream
    equals the port's offline greedy decode of its request."""
    jf, tf, tc, sd = _fleets()
    try:
        if transfer == "live":
            jreqs = _requests(JRequest, JQoS)
            treqs = _requests(TRequest, TQoS)
            assert _live_move(jf, jreqs) == (True, 0)
            assert _live_move(tf, treqs) == (True, 0)
            for f in (jf, tf):
                assert f.report.live_migrations >= 1
                assert any(e.kind == "live" and e.rid == 0
                           for e in f.report.events)
            # rid 0 left replica 0's engine and finished on replica 1's
            assert 0 not in tf.engine_of(tf.replicas[0]).generated
        else:
            jq = JQoS("q", interactive=True, ttft_slo=1e6, tbt_slo=1e6)
            tq = TQoS("q", interactive=True, ttft_slo=1e6, tbt_slo=1e6)
            jreqs = [JRequest(rid=0, arrival=0.0, prompt_len=96,
                              decode_len=4, qos=jq)]
            treqs = [TRequest(rid=0, arrival=0.0, prompt_len=96,
                              decode_len=4, qos=tq)]
            jb = _offload(jf, jreqs[0], JPlan, JPhase)
            tb = _offload(tf, treqs[0], TPlan, TPhase)
            assert 0 in tf.engine_of(tf.replicas[1]).generated
            # the torch payload counts the JAX payload's bytes: pages of
            # 2 layers x 2 blocks, the prompt, cursors
            assert tb == jb > 2 * 2 * 2 * 32 * tc.num_kv_heads \
                * tc.head_dim * 4
        for jrep, trep in zip(jf.replicas, tf.replicas):
            assert trep.backend.plans == jrep.backend.plans
        jgen, tgen = {}, {}
        for f, gen in ((jf, jgen), (tf, tgen)):
            for rep in f.replicas:
                for rid, toks in f.engine_of(rep).generated.items():
                    assert rid not in gen, rid      # streamed once
                    gen[rid] = list(toks)
        assert tgen == jgen
        for r in treqs:
            assert r.phase is TPhase.FINISHED
            assert len(tgen[r.rid]) == r.decode_len
            assert tgen[r.rid] == offline_greedy(
                tc, sd, r.rid, r.prompt_len, r.decode_len), r.rid
    finally:
        jf.close()
        tf.close()


# =====================================================================
# 3. payloads
# =====================================================================

def test_payload_nbytes_counts_the_numpy_form():
    """A torch wire payload and its numpy form (every tensor as its numpy
    array, the JAX engine's format) count the same bytes, under the
    port's and the JAX package's ``payload_nbytes``."""
    _, tc = _configs()
    eng = TorchEngine(tc, device="cpu", **FLEET)
    qos = TQoS("q", interactive=True, ttft_slo=1e6, tbt_slo=1e6)
    r = TRequest(rid=3, arrival=0.0, prompt_len=50, decode_len=4, qos=qos)
    eng.on_admit(r)
    eng.execute(TPlan(prefill=[(r, 50)]), 0.0)
    r.prefilled = 50
    eng.execute(TPlan(decode=[r]), 0.0)
    eng.swap_out(3, eng.pool.block_table(3))
    payload = eng.export_swapped(3)
    swap = payload["swap"]
    as_numpy = dict(payload, swap=dict(swap, pages={
        li: tuple(t.numpy() for t in fields)
        for li, fields in swap["pages"].items()}))
    n = payload_nbytes(payload)
    assert n == payload_nbytes(as_numpy) == jnbytes(as_numpy)
    assert n == (2 * 2 * 2 * 32 * tc.num_kv_heads * tc.head_dim * 4
                 + 50 * 4 + 8 * 2 + 16)


def test_bf16_and_int8_page_engines_refuse_each_others_payloads():
    """int8 pages travel as (k, v, k_scale, v_scale), bf16 pages as (k,
    v): the port's ``_compatible`` refuses the pair in both directions
    (the JAX check, which compares no ``kv_quant``, passes it: ROADMAP
    §3) and accepts two engines of one kind."""
    _, tc = _configs()
    kw = dict(FLEET, dtype=torch.bfloat16, device="cpu")
    b16, b16b = TorchEngine(tc, **kw), TorchEngine(tc, **kw)
    q8 = TorchEngine(tc, kv_quant=True, **kw)
    assert AsyncFleet._compatible(b16, b16b)
    assert AsyncFleet._compatible(q8, TorchEngine(tc, kv_quant=True, **kw))
    assert not AsyncFleet._compatible(b16, q8)
    assert not AsyncFleet._compatible(q8, b16)
    assert JAsyncFleet._compatible(b16, q8)       # the reference's quirk
    assert b16.paged and b16.dtype == torch.bfloat16


# =====================================================================
# 4. wall mode
# =====================================================================

def test_async_server_streams_every_request_once():
    """Two real engines on the CPU behind the asyncio front-end: every
    stream delivers exactly ``decode_len`` events in order, with token
    ids in the vocabulary, and every request finishes exactly once."""
    _, tc = _configs()
    fleet = make_async_torch_fleet(tc, 2, device="cpu", tick=0.05,
                                   **FLEET)
    qos = TQoS("q", interactive=True, ttft_slo=1e6, tbt_slo=1e6)
    reqs = [TRequest(rid=i, arrival=0.0, prompt_len=20 + 9 * i,
                     decode_len=3 + i % 4, qos=qos) for i in range(6)]

    async def main():
        async with AsyncServer(fleet) as srv:
            return await asyncio.gather(*(srv.generate(r, timeout=120.0)
                                          for r in reqs))

    try:
        outs = asyncio.run(main())
    finally:
        fleet.close()
    for r, evs in zip(reqs, outs):
        assert [e.index for e in evs] == list(range(r.decode_len))
        assert all(0 <= e.token < tc.vocab_size for e in evs)
    fin = fleet.finished()
    assert sorted(r.rid for r in fin) == [r.rid for r in reqs]
    assert all(r.phase is TPhase.FINISHED for r in reqs)


def test_serve_fleet_runs_to_the_end(capsys):
    fleet = serve.main(["--fleet", "2", "--device", "cpu", "--reduced",
                        "--n-requests", "6", "--slots", "2", "--max-len",
                        "128", "--tick", "0.05"])
    assert len(fleet.finished()) == 6
    assert all(len(fleet.engine_of(rep).generated.get(r.rid, ())) ==
               r.decode_len for rep in fleet.replicas
               for r in rep.finished)
    out = capsys.readouterr().out
    assert "fleet=2 (async streaming)" in out
    assert "served 6 streams" in out


def test_fleet_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    _, tc = _configs()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_async_torch_fleet(tc, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--fleet", "2", "--reduced"])
    with pytest.raises(SystemExit):
        serve.main(["--fleet", "2", "--backend", "sim"])


def test_metrics_port_waits_for_the_obs_slice():
    """The obs slice is in: ``metrics_port`` makes a registry that the
    fleet's barriers also feed, a caller's ``registry`` is installed on
    the fleet, and ``GET /metrics`` answers from the wall fleet while it
    runs and after its streams end (the twin of
    tests/test_obs.py::test_metrics_http_endpoint on a live fleet)."""
    from repro_torch.obs import MetricsRegistry

    fleet = make_fleet(LLAMA3_8B, 2, controller_cls=AsyncFleet,
                       clock=WallClock())
    try:
        assert fleet.registry is None
        assert AsyncServer(fleet).registry is None and \
            fleet.registry is None
        reg = MetricsRegistry()
        srv = AsyncServer(fleet, registry=reg)
        assert srv.registry is reg and fleet.registry is reg
        assert srv.metrics_port is None
        # a port alone makes the server its own registry; the fleet keeps
        # the one it has, as in the JAX server
        own = AsyncServer(fleet, metrics_port=0).registry
        assert isinstance(own, MetricsRegistry) and own is not reg
        assert fleet.registry is reg
    finally:
        fleet.close()

    _, tc = _configs()
    fleet = make_async_torch_fleet(tc, 2, device="cpu", **FLEET)
    reqs = serve.make_requests(np.random.default_rng(1), 4, 128)

    async def fetch(addr):
        r, w = await asyncio.open_connection(*addr)
        w.write(b"GET /metrics HTTP/1.1\r\nHost: t\r\n\r\n")
        await w.drain()
        data = await r.read()
        w.close()
        return data.decode()

    async def run():
        async with AsyncServer(fleet, metrics_port=0) as srv:
            streams = asyncio.ensure_future(
                serve.stream_all(srv, fleet, reqs))
            during = await fetch(srv.metrics_addr)
            _, _, res = await streams
            return res, during, await fetch(srv.metrics_addr)

    try:
        res, during, after = asyncio.run(run())
    finally:
        fleet.close()
    assert len(res) == 4
    for text in (during, after):
        assert "200 OK" in text and "repro_iterations_total" in text
    assert "repro_requests_finished_total 4" in after
    assert fleet.registry.get("repro_wall_latency_seconds") is not None


# =====================================================================
# 5. the kernel wrappers' counts and builds under threads
# =====================================================================

def test_plain_call_counts_lose_nothing_across_threads():
    x = torch.randn(4, 64)
    w = torch.randn(64)
    n = 3000
    ops.reset_counts()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)     # switch threads as often as possible
    try:
        threads = [threading.Thread(
            target=lambda: [ops.rmsnorm(x, w) for _ in range(n)])
            for _ in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert ops.counts()["rmsnorm"] == {"launches": 0, "plain": 2 * n}
    ops.reset_counts()


def test_kernel_libraries_build_and_load_once_under_threads(monkeypatch):
    """Two threads loading one library run one build and load it once;
    two threads building never overlap."""
    inside, most, builds, loads = [0], [0], [], []

    def fake_build(names):
        inside[0] += 1
        most[0] = max(most[0], inside[0])
        time.sleep(0.05)
        inside[0] -= 1
        builds.append(tuple(names))
        return list(names)

    class _Lib:
        def __init__(self, path):
            loads.append(path)
            self.kernel_error_string = type("F", (), {})()

    monkeypatch.setattr(build, "_build", fake_build)
    monkeypatch.setattr(build.ctypes, "CDLL", _Lib)
    monkeypatch.setattr(build, "_libs", {})
    got = []
    threads = [threading.Thread(
        target=lambda: got.append(build.load_library("rmsnorm")))
        for _ in range(2)]
    threads += [threading.Thread(target=lambda: build.build(["ssd_scan"]))
                for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert most[0] == 1
    assert builds.count(("rmsnorm",)) == 1
    assert builds.count(("ssd_scan",)) == 2
    assert len(loads) == 1 and got[0] is got[1]
