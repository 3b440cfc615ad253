"""Tensor-parallel serving through the stack: the twins of
tests/test_sharded_engine.py's scheduler-stack, collective-byte and
attribution tests, the port's TP = 2 streams and counters against
``JaxEngine(tp=2)`` on the same weights and plans (the 4 host devices
that tests/conftest.py forces), and the KV hierarchy's swap tier and
wire payload on a TP = 2 engine.

Tolerances: none. Streams are compared token for token in f32 and the
byte counters exactly; pages and states of a payload bit for bit.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core.qos import QoSSpec as JQoS  # noqa: E402
from repro.core.request import Request as JRequest  # noqa: E402
from repro.serving.schemes import make_jax_replica  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import kvpool as tkvpool  # noqa: E402
from repro_torch.core.qos import QoSSpec  # noqa: E402
from repro_torch.core.request import Request  # noqa: E402
from repro_torch.core.scheduler import BatchPlan  # noqa: E402
from repro_torch.distributed import TPServePlan  # noqa: E402
from repro_torch.engine.torch_backend import TorchEngine  # noqa: E402
from repro_torch.obs import (Attribution, MetricsRegistry,  # noqa: E402
                             TraceRecorder)
from repro_torch.obs.scrape import _engine_of, scrape_replica  # noqa: E402
from repro_torch.serving import kvcache as tkvc  # noqa: E402
from repro_torch.serving.schemes import make_torch_replica  # noqa: E402

QOS = QoSSpec("q", interactive=True, ttft_slo=1e6, tbt_slo=1e6)
BS = 16


def reduced(arch):
    return get_config(arch).reduced(num_layers=2, d_model=64)


class _FixedClock:
    """Constant reported iteration time: both replicas make identical
    scheduling decisions, isolating engine numerics from wall clock."""

    def __init__(self, inner):
        self.inner = inner

    def execute(self, plan, now):
        self.inner.execute(plan, now)
        return 0.05

    def __getattr__(self, name):
        return getattr(self.inner, name)


STACK_KW = dict(n_slots=2, max_len=128, block_size=32, quantum=16, seed=5)


def _stack_requests(req_cls, qos):
    return [req_cls(rid=i, arrival=0.4 * i, prompt_len=18 + 7 * i,
                    decode_len=3 + (i % 3), qos=qos, app_id="a")
            for i in range(4)]


def _run_stack(cfg, tp, params=None, tracer=None):
    rep = make_torch_replica("niyama", cfg, tp=tp, device="cpu",
                             params=params, backend_wrap=_FixedClock,
                             **STACK_KW)
    rep.tracer = tracer
    try:
        rep.submit_all(_stack_requests(Request, QOS))
        rep.run()
    finally:
        rep.backend.close()
    assert len(rep.finished) == 4
    return rep


# ------------------------------------------------------- scheduler stack
def test_scheduler_stack_tp2_bit_identity_and_metrics():
    """The NiyamaScheduler / Replica stack at TP = 2 against tp = 1:
    identical streams; the engine's collective-byte counters surface in
    the scrape as ``repro_tp_collective_bytes_total{op=}``, and the
    traced run's attribution puts the scheduler's collective term in its
    own bin, the bins still summing to each request's latency."""
    cfg = reduced("llama3.2-3b")
    r1 = _run_stack(cfg, tp=1)
    rec = TraceRecorder()
    r2 = _run_stack(cfg, tp=2, params=r1.backend.inner.params.state_dict(),
                    tracer=rec)
    assert r2.backend.generated == r1.backend.generated
    eng = _engine_of(r2)
    assert eng.tp == 2
    assert eng.tp_collective_bytes
    assert all(b > 0 for b in eng.tp_collective_bytes.values())
    reg = MetricsRegistry()
    scrape_replica(reg, r2)
    text = reg.render()
    assert "repro_tp_collective_bytes_total" in text
    assert 'op="heads"' in text
    assert "repro_tp_devices" in text
    reg1 = MetricsRegistry()
    scrape_replica(reg1, r1)
    assert "repro_tp_collective_bytes_total" not in reg1.render()
    att = Attribution(rec)
    bds = [att.explain(r.rid) for r in r2.all_requests()]
    for ex in bds:
        assert sum(ex["breakdown"].values()) == pytest.approx(ex["e2e"])
    assert all(ex["breakdown"]["collective_overhead"] > 0 for ex in bds)


def test_collective_byte_accounting_matches_plan():
    """The engine's counters equal ``TPServePlan.collective_bytes`` summed
    over the dispatches it ran (JAX's account: real tokens, 4 bytes an
    element), and the bytes the ranks' gathers received, summed over the
    ranks, equal the same account over the padded rows the gathers
    really moved (prefill P x L tokens and every decode slot), in f32."""
    cfg = reduced("llama3.2-3b")
    eng = TorchEngine(cfg, n_slots=2, max_len=128, quantum=16, seed=7,
                      tp=2, kv_layout="paged", block_size=32, device="cpu")
    try:
        plan = TPServePlan(cfg, 2)
        reqs = [Request(rid=i, arrival=0.0, prompt_len=20, decode_len=2,
                        qos=QOS) for i in range(2)]
        for r in reqs:
            eng.on_admit(r)
        eng.reset_rank_stats()
        # 2 requests fill the 2-row bucket, so the logits gather's rows
        # equal the logical ones
        eng.execute(BatchPlan(prefill=[(r, 20) for r in reqs]), 0.0)
        for r in reqs:
            r.prefilled = 20
        want = plan.collective_bytes(40, 2)     # 40 prefill tokens, 2 rows
        eng.execute(BatchPlan(decode=list(reqs)), 0.0)
        for op, b in plan.collective_bytes(2, 2).items():
            want[op] = want.get(op, 0.0) + b
        assert eng.tp_collective_bytes == want
        # the gathers: the prefill rows pad 20 tokens to the 32 bucket
        moved = plan.collective_bytes(2 * 32, 2)
        for op, b in plan.collective_bytes(2, 2).items():
            moved[op] += b
        recv = {}
        for st in eng.rank_stats():
            for op, b in st["recv_bytes"].items():
                recv[op] = recv.get(op, 0) + b
        assert recv == moved
    finally:
        eng.close()


# ----------------------------------------------------------- attribution
def test_attribution_collective_overhead_bin():
    """comm_s from the scheduler trace lands in its own cause bin, carved
    out of service, and the bins still sum to end-to-end latency."""
    events = [
        {"kind": "arrive", "t": 0.0, "rid": 1},
        {"kind": "iter", "t": 1.0, "t0": 1.0, "elapsed": 2.0,
         "predicted": 1.8, "sched": {"comm_s": 0.5},
         "prefill": [(1, 32)], "decode": []},
        {"kind": "finish", "t": 3.0, "rid": 1},
    ]
    ex = Attribution(events).explain(1)
    bd = ex["breakdown"]
    assert bd["collective_overhead"] == pytest.approx(0.5)
    assert bd["service"] == pytest.approx(1.3)       # predicted - comm
    assert bd["predictor_error"] == pytest.approx(0.2)
    assert sum(bd.values()) == pytest.approx(ex["e2e"])
    events[1]["sched"] = {}
    bd0 = Attribution(events).explain(1)["breakdown"]
    assert bd0["collective_overhead"] == 0.0
    assert bd0["service"] == pytest.approx(1.8)


# ------------------------------------------------------ against JAX's TP
@pytest.mark.parametrize("arch", ["llama3.2-3b", "qwen3-moe-30b-a3b",
                                  "jamba-v0.1-52b"])
def test_streams_and_counters_equal_jax_tp2(arch):
    """``make_torch_replica(tp=2)`` and ``make_jax_replica(tp=2)`` on the
    JAX engine's weights, behind the fixed clock: the same plans, the
    same streams and the same ``tp_collective_bytes``, exactly."""
    jc = jax_get_config(arch).reduced(num_layers=2, d_model=64)
    jrep = make_jax_replica("niyama", jc, tp=2, backend_wrap=_FixedClock,
                            **STACK_KW)
    jrep.submit_all(_stack_requests(
        JRequest, JQoS("q", interactive=True, ttft_slo=1e6, tbt_slo=1e6)))
    jrep.run()
    jeng = jrep.backend.inner
    sd = bridge.params_from_numpy(jax.tree.map(np.asarray, jeng.params))
    trep = _run_stack(reduced(arch), tp=2, params=sd)
    teng = trep.backend.inner
    assert {k: list(v) for k, v in teng.generated.items()} == \
        {k: list(v) for k, v in jeng.generated.items()}
    assert teng.tp_collective_bytes == jeng.tp_collective_bytes
    assert teng.buckets_seen == jeng.buckets_seen


# ------------------------------------------------------ swap and the wire
def _hier(cfg, kv_quant=False):
    return tkvc.KVHierarchy(
        8, BS, cfg=tkvc.KVCacheConfig(enable_swap=True),
        bytes_per_block=tkvpool.kv_bytes_per_block(cfg, BS,
                                                   kv_quant=kv_quant),
        max_seqs=2)


def _engine(cfg, tp, pool=None, **kw):
    return TorchEngine(cfg, n_slots=2, max_len=128, quantum=16, seed=7,
                       block_size=BS, pool=pool, device="cpu", tp=tp, **kw)


def _req(rid=0, prompt=40, decode=6):
    return Request(rid=rid, arrival=0.0, prompt_len=prompt,
                   decode_len=decode, qos=QOS)


def _swapped_out(eng, kv):
    """Prefill 40 tokens, decode 2, then swap the request out (its pages
    and Mamba state to the host tier, its blocks freed). Returns the
    request and the blocks it held."""
    r = _req()
    eng.on_admit(r)
    eng.execute(BatchPlan(prefill=[(r, 40)]), 0.0)
    r.prefilled = 40
    for _ in range(2):
        eng.execute(BatchPlan(decode=[r]), 0.0)
    held = list(kv.block_table(r.rid))
    assert kv.on_relegate(r.rid, 42) == 42
    eng.on_release(r)
    assert kv.private_blocks(r.rid) == 0
    return r, held


def test_tp2_swap_round_trip_streams_equal_tp1():
    """jamba (an attention and a Mamba2 layer): a request swapped out
    mid-decode on a TP = 2 engine (each rank parks its kv-heads and its
    copy of the recurrent state), its blocks churned by another request,
    then swapped back in, streams what an uninterrupted tp = 1 run
    streams."""
    cfg = reduced("jamba-v0.1-52b")
    base = _engine(cfg, 1)
    r = _req()
    base.on_admit(r)
    base.execute(BatchPlan(prefill=[(r, 40)]), 0.0)
    r.prefilled = 40
    for _ in range(5):
        base.execute(BatchPlan(decode=[r]), 0.0)

    kv = _hier(cfg)
    eng = _engine(cfg, 2, pool=kv, params=base.params.state_dict())
    try:
        r, held = _swapped_out(eng, kv)
        other = _req(rid=9, prompt=33, decode=2)
        eng.on_admit(other)
        kv.grow(9, 33)
        assert set(kv.block_table(9)) & set(held)
        eng.execute(BatchPlan(prefill=[(other, 33)]), 0.0)
        other.prefilled = 33
        eng.execute(BatchPlan(decode=[other]), 0.0)
        eng.on_release(other)
        kv.release(9)
        for _ in range(3):
            eng.execute(BatchPlan(decode=[r]), 0.0)  # swap-resume
        assert eng.generated[0] == base.generated[0]
        assert r.rid not in eng._swap_store
    finally:
        eng.close()


def test_tp2_export_payload_equals_tp1_and_lands_back():
    """jamba with int8 pages: ``export_swapped`` of a TP = 2 engine
    gathers the ranks' kv-heads into the payload a tp = 1 engine exports
    after the same calls (pages, scale pages and Mamba state bit for
    bit); ``import_swapped`` into a fresh TP = 2 engine cuts it back per
    rank, and decoding on streams what the tp = 1 engine streams
    uninterrupted."""
    cfg = reduced("jamba-v0.1-52b")
    kv1 = _hier(cfg, kv_quant=True)
    one = _engine(cfg, 1, pool=kv1, kv_quant=True)
    sd = one.params.state_dict()
    _swapped_out(one, kv1)
    want = one.export_swapped(0)

    base = _engine(cfg, 1, kv_quant=True, params=sd)
    r = _req()
    base.on_admit(r)
    base.execute(BatchPlan(prefill=[(r, 40)]), 0.0)
    r.prefilled = 40
    for _ in range(5):
        base.execute(BatchPlan(decode=[r]), 0.0)

    kv2 = _hier(cfg, kv_quant=True)
    two = _engine(cfg, 2, pool=kv2, kv_quant=True, params=sd)
    try:
        _swapped_out(two, kv2)
        got = two.export_swapped(0)
        blocks, tokens = kv2.host.held(0), kv2.swapped_tokens(0)
        kv2.release(0)
    finally:
        two.close()
    assert got["prompt"].tolist() == want["prompt"].tolist()
    assert got["generated"] == want["generated"]
    for key in ("tokens", "last_token"):
        assert got["swap"][key] == want["swap"][key]
    for part in ("pages", "mamba"):
        assert got["swap"][part].keys() == want["swap"][part].keys()
        for li, fields in want["swap"][part].items():
            assert [t.dtype for t in got["swap"][part][li]] == \
                [t.dtype for t in fields]
            assert all(torch.equal(a, b) for a, b in
                       zip(got["swap"][part][li], fields)), (part, li)

    kv3 = _hier(cfg, kv_quant=True)
    dst = _engine(cfg, 2, pool=kv3, kv_quant=True, params=sd)
    try:
        assert kv3.host_receive(0, blocks, tokens)
        dst.import_swapped(0, got)
        tr = _req()
        tr.prefilled = 40
        for _ in range(3):
            dst.execute(BatchPlan(decode=[tr]), 0.0)
        assert dst.generated[0] == base.generated[0]
    finally:
        dst.close()
