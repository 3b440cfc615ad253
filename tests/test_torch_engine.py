"""``TorchEngine`` behind the port's Replica + NiyamaScheduler streams the
same greedy tokens as ``JaxEngine`` behind the JAX package's, on the JAX
engine's weights carried across by ``repro_torch.bridge``.

Both replicas run under a fixed clock (the shim of
tests/test_fused_engine.py), so their schedulers make the same decisions
and any difference in the streams is the engines' own. The request sets
cover slot reuse (4 requests through 2 slots), a prompt-completing chunk
beside a live decode batch, and page-window bucket transitions, for the
dense family (two head layouts) and the Mamba2 family.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402

import jax  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core.qos import QoSSpec as JQoS  # noqa: E402
from repro.core.request import Request as JRequest  # noqa: E402
from repro.serving.schemes import make_jax_replica  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.qos import QoSSpec as TQoS  # noqa: E402
from repro_torch.core.request import Request as TRequest  # noqa: E402
from repro_torch.engine.torch_backend import TorchEngine  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.serving.schemes import make_torch_replica  # noqa: E402

NARROW = dict(num_heads=6, num_kv_heads=2, head_dim=32)


class _FixedClock:
    """Backend wrapper reporting a constant iteration time so two replicas
    with different engines make IDENTICAL scheduling decisions — isolating
    engine numerics from wall-clock-driven plan divergence. Also records
    each plan: ((rid, chunk, completes prompt), ...), (decode rids)."""

    def __init__(self, inner):
        self.inner = inner
        self.plans = []

    def execute(self, plan, now):
        self.plans.append((
            tuple((r.rid, c, r.prefilled + c >= r.prompt_len)
                  for r, c in plan.prefill),
            tuple(r.rid for r in plan.decode)))
        self.inner.execute(plan, now)
        return 0.05

    def __getattr__(self, name):
        return getattr(self.inner, name)


def _configs(name):
    arch = "mamba2-370m" if name == "mamba" else "llama3.2-3b"
    jc = jax_get_config(arch).reduced(num_layers=2, d_model=128)
    tc = get_config(arch).reduced(num_layers=2, d_model=128)
    if name == "narrow":
        jc = dataclasses.replace(jc, **NARROW)
        tc = dataclasses.replace(tc, **NARROW)
    return jc, tc


def _requests(req_cls, qos_cls, n):
    qos = qos_cls("q", interactive=True, ttft_slo=1e6, tbt_slo=1e6)
    return [req_cls(rid=i, arrival=0.15 * i, prompt_len=18 + 23 * i,
                    decode_len=6 + 3 * (i % 3), qos=qos, app_id="a")
            for i in range(n)]


def _cost_fields(cost):
    """A ``BatchPlanCost``'s fields as plain lists (``decode_ctxs`` may
    be a numpy array)."""
    return {k: np.asarray(v).tolist()
            for k, v in dataclasses.asdict(cost).items()}


@pytest.mark.parametrize("cfg_name", ["reduced", "narrow", "mamba"])
def test_torch_replica_streams_equal_jax_replica(cfg_name):
    jc, tc = _configs(cfg_name)
    kw = dict(n_slots=2, max_len=128, block_size=16, quantum=16, seed=5)
    jrep = make_jax_replica("niyama", jc, backend_wrap=_FixedClock, **kw)
    sd = bridge.params_from_numpy(
        jax.tree.map(np.asarray, jrep.backend.inner.params))
    trep = make_torch_replica("niyama", tc, device="cpu", params=sd,
                              backend_wrap=_FixedClock, **kw)
    for rep, req_cls, qos_cls in ((jrep, JRequest, JQoS),
                                  (trep, TRequest, TQoS)):
        rep.submit_all(_requests(req_cls, qos_cls, 4))
        rep.run()
        assert len(rep.finished) == 4
    jeng, teng = jrep.backend.inner, trep.backend.inner
    assert trep.backend.plans == jrep.backend.plans
    assert teng.generated == jeng.generated
    for r in trep.all_requests():
        assert len(teng.generated[r.rid]) == r.decode_len
    plans = trep.backend.plans
    # a prompt-completing chunk ran beside a live decode batch
    assert any(dec and any(done for _, _, done in pre)
               for pre, dec in plans)
    # 4 requests through 2 slots: slots were reused
    assert len(teng.generated) == 4 and teng.n_slots == 2
    # the page window grew through several buckets, as in JAX
    assert len(teng.gather_bucket_hits) >= 3
    assert teng.gather_bucket_hits == jeng.gather_bucket_hits
    # the reference's interfaces: one (plan.cost(), seconds) entry per
    # executed plan with the same costs, and the same shape buckets
    assert len(teng.iteration_log) == len(jeng.iteration_log) == len(plans)
    for (tcost, tsec), (jcost, jsec) in zip(teng.iteration_log,
                                           jeng.iteration_log):
        assert _cost_fields(tcost) == _cost_fields(jcost)
        assert tsec > 0 and jsec > 0
    assert teng.buckets_seen == jeng.buckets_seen
    assert len(teng.buckets_seen) >= 3


def test_warm_runs_both_attention_paths_without_writing_live_pages():
    _, tc = _configs("narrow")
    eng = TorchEngine(tc, n_slots=3, max_len=64, quantum=16, block_size=16,
                      device="cpu")
    for c in eng.cache["layers"]:
        c.k.normal_()
    before = [c.k[:-1].clone() for c in eng.cache["layers"]]
    ops.reset_counts()
    eng.warm()
    # norm1 and norm2 of both sub-batches in every layer, and the final
    # norm once over the sampled rows
    assert ops.counts() == {
        "paged_attention": {"launches": 0, "plain": tc.num_layers},
        "paged_attention_int8": {"launches": 0, "plain": 0},
        "chunked_prefill_attention": {"launches": 0,
                                      "plain": tc.num_layers},
        "rmsnorm": {"launches": 0, "plain": 4 * tc.num_layers + 1},
        "ssd_scan": {"launches": 0, "plain": 0}}
    for b, c in zip(before, eng.cache["layers"]):
        assert torch.equal(b, c.k[:-1])
    ops.reset_counts()


def test_engine_backpressure_defers_prefill_tail():
    """preflight raises a deferrable EngineBackpressure naming how many
    prefill items fit, before any state changes."""
    from repro_torch.core.backpressure import EngineBackpressure
    from repro_torch.core.scheduler import BatchPlan
    _, tc = _configs("reduced")
    eng = TorchEngine(tc, n_slots=2, max_len=64, quantum=16, block_size=16,
                      device="cpu")
    reqs = _requests(TRequest, TQoS, 3)
    with pytest.raises(EngineBackpressure) as ei:
        eng.execute(BatchPlan(prefill=[(r, 16) for r in reqs]), 0.0)
    assert ei.value.n_prefill_fit == 2 and ei.value.deferrable
    assert eng.slot_of == {} and eng.pool.used == 0
