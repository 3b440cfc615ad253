"""The port's program spans (``repro_torch.obs.spans``): off by default
and structurally free there, inert when on, one ``engine.*`` span of each
kind per ``TorchEngine.execute`` summing to the engine's own seconds,
nested in ``replica.execute`` on a CPU ``torch.profiler``'s timeline, and
one ``engine.host_read`` per MoE layer and sub-batch of the grouped FFN.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.qos import QoSSpec  # noqa: E402
from repro_torch.core.request import Request  # noqa: E402
from repro_torch.models.config import MOE  # noqa: E402
from repro_torch.obs import span, spans  # noqa: E402
from repro_torch.serving.schemes import make_torch_replica  # noqa: E402

ENGINE = ("engine.pack", "engine.launch", "engine.sync", "engine.post")
REPLICA = ("replica.admit", "replica.schedule", "replica.execute",
           "replica.apply")


@pytest.fixture(autouse=True)
def _spans_off():
    spans.enable(False)
    spans.reset()
    yield
    spans.enable(False)
    spans.reset()


class _Plans:
    """A constant iteration time, so the scheduler decides alike however
    fast the engine runs, and each executed plan's (prefill (rid,
    chunk), decode rids)."""

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


def _requests(n=4):
    q = QoSSpec("chat", interactive=True, ttft_slo=5.0, tbt_slo=1.0)
    return [Request(rid=i, arrival=0.08 * i, prompt_len=24 + 9 * i,
                    decode_len=3 + i, qos=q, app_id="chat")
            for i in range(n)]


def _replica(arch="llama3.2-3b", wrap=_Plans):
    cfg = get_config(arch).reduced(num_layers=2, d_model=128)
    return make_torch_replica("niyama", cfg, device="cpu", n_slots=2,
                              max_len=128, block_size=16, quantum=16,
                              seed=3, backend_wrap=wrap), cfg


def _steps(rep, reqs):
    """Step the replica until drained; each step's delta of the span
    table."""
    rep.submit_all(reqs)
    deltas = []
    while True:
        before = spans.totals()
        more = rep.step()
        after = spans.totals()
        deltas.append({k: (c - before.get(k, (0, 0.0))[0],
                           s - before.get(k, (0, 0.0))[1])
                       for k, (c, s) in after.items()
                       if c != before.get(k, (0, 0.0))[0]})
        if not more:
            return deltas


def test_off_by_default_returns_the_shared_null_context():
    assert not spans._ON
    assert not torch.autograd._profiler_enabled()
    s = span("engine.launch")
    assert s is spans._NULL and span("moe.router") is s
    with span("replica.step"):
        pass
    assert spans.totals() == {}


def test_on_counts_calls_and_seconds_and_reset_clears():
    spans.enable(True)
    for _ in range(3):
        with span("engine.pack"):
            pass
    with pytest.raises(ValueError):
        with span("engine.post"):
            raise ValueError("a span closes on the way out")
    t = spans.totals()
    assert t["engine.pack"][0] == 3 and t["engine.post"][0] == 1
    assert all(s >= 0.0 for _, s in t.values())
    spans.reset()
    assert spans.totals() == {}


def test_spans_on_change_no_plan_and_no_token():
    """The same requests through the same reduced replica, spans off and
    on: the same plans, the same tokens, and the table filled only on."""
    runs = []
    for on in (False, True):
        spans.enable(on)
        rep, _ = _replica()
        _steps(rep, _requests())
        runs.append((rep.backend.plans, dict(rep.backend.inner.generated),
                     spans.totals()))
    (plans0, gen0, tab0), (plans1, gen1, tab1) = runs
    assert len(plans0) > 3 and plans0 == plans1
    assert gen0 == gen1 and all(len(g) for g in gen0.values())
    assert tab0 == {}
    assert set(ENGINE + REPLICA) <= set(tab1)


def test_one_execute_records_each_engine_span_once():
    """With spans on, one step of a reduced dense model: each ``engine.*``
    span once, each ``replica.*`` once, and the four engine spans' seconds
    sum to that step's ``iteration_log`` seconds within 5%."""
    rep, _ = _replica(wrap=None)
    q = QoSSpec("chat", interactive=True, ttft_slo=5.0, tbt_slo=1.0)
    rep.submit(Request(rid=0, arrival=0.0, prompt_len=96, decode_len=4,
                       qos=q, app_id="chat"))
    rep.step()              # the first step pays the allocator's warm-up
    spans.enable(True)
    rep.step()
    t = spans.totals()
    assert {k: t[k][0] for k in ENGINE + REPLICA} == \
        {k: 1 for k in ENGINE + REPLICA}
    assert "engine.host_read" not in t      # a dense FFN reads nothing
    engine_s = rep.backend.iteration_log[-1][1]
    assert sum(t[k][1] for k in ENGINE) == pytest.approx(engine_s, rel=0.05)
    assert t["replica.execute"][1] >= engine_s


@pytest.mark.parametrize("on", [False, True])
def test_engine_spans_nest_in_replica_execute_on_the_profiler_clock(on):
    """Under a CPU ``torch.profiler``, with the table off (the profiler
    alone) and on: every ``engine.*`` span is a host event inside a
    ``replica.execute`` event, and each step's four follow one another."""
    from torch.profiler import ProfilerActivity, profile

    spans.enable(on)
    rep, _ = _replica()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _steps(rep, _requests(2))
    ev = [e for e in prof.events()
          if e.name.startswith(("engine.", "replica."))]
    execs = [e.time_range for e in ev if e.name == "replica.execute"]
    assert len(execs) == len(rep.backend.plans) > 0
    by_name = {k: sorted((e.time_range.start, e.time_range.end)
                         for e in ev if e.name == k) for k in ENGINE}
    assert all(len(v) == len(execs) for v in by_name.values())
    for i, r in enumerate(sorted(execs, key=lambda r: r.start)):
        prev = r.start
        for k in ENGINE:
            a, b = by_name[k][i]
            assert prev <= a <= b <= r.end, (k, i)
            prev = b
    assert (spans.totals() != {}) == on


def test_grouped_moe_reads_the_host_once_per_layer_and_sub_batch():
    """A reduced MoE model served by the grouped FFN: each step reads its
    largest expert segment once per MoE layer for each sub-batch it runs
    (prefill, decode), inside ``engine.host_read``."""
    spans.enable(True)
    rep, cfg = _replica("qwen3-moe-30b-a3b")
    n_moe = sum(l.ffn == MOE for l in cfg.layers)
    assert n_moe > 0
    deltas = _steps(rep, _requests())
    plans = rep.backend.plans
    executed = [d for d in deltas if "engine.launch" in d]
    assert len(executed) == len(plans)
    both = 0
    for d, (pre, dec) in zip(executed, plans):
        subs = bool(pre) + bool(dec)
        both += subs == 2
        assert d["engine.host_read"][0] == n_moe * subs
    assert both > 0
