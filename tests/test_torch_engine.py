"""``TorchEngine`` behind the port's Replica + NiyamaScheduler streams the
same greedy tokens as ``JaxEngine`` behind the JAX package's, on the JAX
engine's weights carried across by ``repro_torch.bridge``.

Both replicas run under a fixed clock (the shim of
tests/test_fused_engine.py), so their schedulers make the same decisions
and any difference in the streams is the engines' own. The request sets
cover slot reuse (4 requests through 2 slots), a prompt-completing chunk
beside a live decode batch, and page-window bucket transitions, for the
dense family (two head layouts), the Mamba2 family, and the reduced
configs of every other served architecture: the MoE decoders, the
attention + Mamba2 + MoE hybrid, the dense code models and the paper's
own two models. The JAX engine serves MoE layers through its default
``moe_impl="grouped"``, as the port does.

The same configs also run one mixed iteration through both packages'
``fused_serve_forward``: the sampled rows' final hidden states agree
within 1e-5 (f32; XLA and ATen sum in different orders, as in
tests/test_torch_model.py) and the sampled ids are equal.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import paper_models as jax_paper_models  # noqa: E402
from repro.core.qos import QoSSpec as JQoS  # noqa: E402
from repro.core.request import Request as JRequest  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.serving.schemes import make_jax_replica  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config, paper_models  # noqa: E402
from repro_torch.core.qos import QoSSpec as TQoS  # noqa: E402
from repro_torch.core.request import Request as TRequest  # noqa: E402
from repro_torch.engine.torch_backend import TorchEngine  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models.config import MOE  # noqa: E402
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


# the reduced configs of the architectures served since the MoE slice:
# registry ids, and the paper's models by their config names
NEW_ARCHS = ["qwen3-moe-30b-a3b", "dbrx-132b", "jamba-v0.1-52b",
             "granite-8b", "starcoder2-15b", "llama3-8b", "qwen-7b"]
_PAPER = {"llama3-8b": "LLAMA3_8B", "qwen-7b": "QWEN_7B"}


def _full(name):
    """(JAX config, port config) at full size."""
    if name in _PAPER:
        return (getattr(jax_paper_models, _PAPER[name]),
                getattr(paper_models, _PAPER[name]))
    arch = {"reduced": "llama3.2-3b", "narrow": "llama3.2-3b",
            "mamba": "mamba2-370m"}.get(name, name)
    return jax_get_config(arch), get_config(arch)


def _configs(name):
    """The two packages' ``.reduced(num_layers=2, d_model=128)`` configs.
    jamba's two reduced layers would both carry a dense FFN (its MoE
    layers sit at odd offsets): it keeps its layer 1 (Mamba2 + MoE) and
    layer 4 (attention + dense) instead, so every kind it has runs."""
    jfull, tfull = _full(name)
    jc = jfull.reduced(num_layers=2, d_model=128)
    tc = tfull.reduced(num_layers=2, d_model=128)
    if name == "narrow":
        jc = dataclasses.replace(jc, **NARROW)
        tc = dataclasses.replace(tc, **NARROW)
    if name == "jamba-v0.1-52b":
        jc = dataclasses.replace(jc, layers=(jfull.layers[1],
                                             jfull.layers[4]))
        tc = dataclasses.replace(tc, layers=(tfull.layers[1],
                                             tfull.layers[4]))
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
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


@pytest.mark.parametrize("cfg_name",
                         ["reduced", "narrow", "mamba"] + NEW_ARCHS)
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


def _mixed_plan(cfg, rng, n_slots=4):
    """Two prefill rows (one resuming at 16 tokens) and two pad rows; a
    decode batch of 4 slots, two active. The arrays in the order of
    ``fused_serve_forward``'s arguments, and the rows that are live."""
    maxb = 4
    pre_tokens = rng.integers(0, cfg.vocab_size, (4, 32)).astype(np.int32)
    pre_slots = np.array([0, 1, n_slots, n_slots], np.int32)
    pre_reset = np.array([True, False, False, False])
    pre_start = np.array([0, 16, 0, 0], np.int32)
    pre_len = np.array([20, 25, 0, 0], np.int32)
    pre_sample = np.array([19, 24, 0, 0], np.int32)
    pre_bt = np.full((4, maxb), -1, np.int32)
    pre_bt[0, :2] = [3, 7]
    pre_bt[1, :3] = [0, 9, 12]
    dec_tokens = rng.integers(0, cfg.vocab_size, n_slots).astype(np.int32)
    dec_start = np.array([0, 16, 37, 5], np.int32)
    dec_active = np.array([False, False, True, True])
    dec_bt = np.full((n_slots, maxb), -1, np.int32)
    dec_bt[2, :3] = [10, 11, 14]
    dec_bt[3, :1] = [2]
    return (pre_tokens, pre_slots, pre_start, pre_len, pre_reset,
            pre_sample, dec_tokens, dec_start, dec_active, pre_bt,
            dec_bt), np.r_[pre_len > 0, dec_active]


def _jax_hidden(params, cfg, cache, pre_tokens, pre_slots, pre_start,
                pre_len, pre_reset, pre_sample, dec_tokens, dec_start,
                dec_active, pre_bt, dec_bt):
    """JAX's fused_serve_forward (``moe_impl="grouped"``) stopped before
    its LM head: the rows the head reads."""
    P, L = pre_tokens.shape
    x_pre = JT._embed(params, cfg, pre_tokens, None)
    x_dec = JT._embed(params, cfg, dec_tokens[:, None], None)
    pre_valid = jnp.arange(L)[None, :] < pre_len[:, None]
    for li, spec in enumerate(cfg.layers):
        x_pre, x_dec, _ = JT._fused_block(
            params["layers"][li], cfg, spec, x_pre, x_dec,
            cache["layers"][li], pre_slots, pre_start, pre_len, pre_reset,
            pre_valid, dec_start, dec_active, JT._identity_shard, "jnp",
            pre_bt=pre_bt, dec_bt=dec_bt, moe_impl="grouped")
    x_pre = JL.rmsnorm(x_pre, params["final_norm"], cfg.norm_eps)
    x_dec = JL.rmsnorm(x_dec, params["final_norm"], cfg.norm_eps)
    return jnp.concatenate([x_pre[jnp.arange(P), pre_sample], x_dec[:, 0]])


@pytest.mark.parametrize("cfg_name", NEW_ARCHS)
def test_fused_hidden_states_match_jax(cfg_name):
    jc, tc = _configs(cfg_name)
    assert any(l.ffn == MOE for l in tc.layers) == (tc.moe is not None)
    rng = np.random.default_rng(2)
    jp = JT.init_params(jax.random.PRNGKey(3), jc)
    model = TT.Transformer(tc, "cpu", torch.float32)
    model.load_state_dict(bridge.params_from_numpy(
        jax.tree.map(np.asarray, jp)), strict=True)
    n_slots, nb, bs = 4, 16, 16
    jcache = JT.init_paged_cache(jc, n_slots, nb, bs)
    # stale KV in every page and a recurrent state in every slot
    jcache = jax.tree.map(
        lambda a: jnp.asarray(rng.standard_normal(a.shape, np.float32)),
        jcache)
    arrs, live = _mixed_plan(tc, rng, n_slots)
    jarrs = [jnp.asarray(a) for a in arrs]
    want_ids, _ = JT.fused_serve_forward(
        jp, jc, jcache, *jarrs[:9], pre_bt=jarrs[9], dec_bt=jarrs[10])
    want = np.asarray(_jax_hidden(jp, jc, jcache, *jarrs))

    host = jax.tree.map(np.asarray, jcache)
    tarrs = [torch.from_numpy(a) for a in arrs]
    with torch.inference_mode():
        hid = TT._sampled_hidden(
            model, tc, bridge.paged_cache_from_numpy(host, device="cpu"),
            *tarrs)
    ids = TT.fused_serve_forward(
        model, tc, bridge.paged_cache_from_numpy(host, device="cpu"),
        *tarrs)
    np.testing.assert_allclose(hid.numpy()[live], want[live], rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(ids.numpy()[live],
                                  np.asarray(want_ids)[live])
