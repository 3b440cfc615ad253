"""The sliding-window serve path of the port against the JAX package.

- The plain attention versions at gemma3-4b's head_dim 256, with a
  window and with ``-1`` table holes (the blocks that SWA reclamation
  freed), against the Pallas functions in interpret mode: f32,
  tolerance 2e-5 (summation order only, as tests/test_torch_kernels.py).
- ``get_config(arch, shape)`` resolves every served architecture, and
  the ``long_500k`` (swa_500k) variant, to the JAX registry's config.
- ``TorchEngine`` behind the port's Replica streams the same greedy
  tokens as ``JaxEngine`` for the reduced gemma3-4b (sliding-window and
  global layers) and the reduced ``long_500k`` llama (every layer
  sliding, so pages are reclaimed); one mixed iteration's sampled hidden
  states agree within 1e-5 with JAX's ``attn_impl="jnp"`` and
  ``"pallas"`` paths.
- SWA page reclamation, the twins of tests/test_swa_reclaim.py against
  ``JaxEngine``: the gate, a decode that sheds blocks mid-stream while a
  concurrent request reuses the freed id, the prefill-phase reclaim, and
  ``kv_blocks_reclaimed`` and the block tables equal to JAX's.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCH_IDS  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core.qos import QoSSpec as JQoS  # noqa: E402
from repro.core.request import Request as JRequest  # noqa: E402
from repro.core.scheduler import BatchPlan as JPlan  # noqa: E402
from repro.engine.jax_backend import JaxEngine  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.serving.schemes import make_jax_replica  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import NOT_PORTED, get_config  # noqa: E402
from repro_torch.core.qos import QoSSpec as TQoS  # noqa: E402
from repro_torch.core.request import Request as TRequest  # noqa: E402
from repro_torch.core.scheduler import BatchPlan as TPlan  # noqa: E402
from repro_torch.engine.torch_backend import TorchEngine  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models.config import ATTN, SWA  # noqa: E402
from repro_torch.serving.schemes import make_torch_replica  # noqa: E402

TOL = 2e-5       # f32 attention: summation order only
HIDDEN = 1e-5    # f32 hidden states: XLA and ATen sum in other orders


def _np(a):
    return np.ascontiguousarray(a)


# ---------------------------------------------------------------- kernels

def _pages(rng, P, page, KV, D):
    return (rng.standard_normal((P, page, KV, D), np.float32),
            rng.standard_normal((P, page, KV, D), np.float32))


def _table(rng, lens, P, page, n_pages):
    """Block tables of rows of ``lens`` tokens over distinct pages."""
    bt = np.full((len(lens), n_pages), -1, np.int32)
    ids = rng.permutation(P)
    for b, n in enumerate(lens):
        k = -(-n // page)
        bt[b, :k] = ids[b * n_pages:b * n_pages + k]
    return bt


def _holes(bt, starts, page, window):
    """``bt`` with the -1 holes that SWA reclamation left after the
    iteration before: a row whose chunk starts at ``start`` had ``start``
    tokens then, and its blocks of positions <= start - window, dead to
    every query at or past ``start``, were freed."""
    bt = bt.copy()
    for b, n in enumerate(starts):
        bt[b, :max(0, (n - window + 1) // page)] = -1
    return bt


@pytest.mark.parametrize("C,window,holes", [
    (32, None, False),     # a causal chunk at D 256
    (32, 64, True),        # S longer than the window, dead blocks as holes
    (1, 64, True),         # windowed decode rows: C = 1 over the view
])
def test_plain_prefill_d256_window_holes_vs_pallas(C, window, holes):
    """The view is gathered through block tables as ``_paged_view`` does
    (holes read page 0); q offsets are ragged, one row is a pad row."""
    B, H, KV, D, page, n_pages = 4, 4, 2, 256, 16, 16
    rng = np.random.default_rng(0)
    kp, vp = _pages(rng, B * n_pages + 1, page, KV, D)
    offs = np.array([0, 100, 200, 0], np.int32)[:B]
    if C == 1:
        offs = np.array([255, 130, 63, 0], np.int32)
    lens = np.where(np.arange(B) == B - 1, 0, offs + C).astype(np.int32)
    full = _table(rng, [max(int(n), 1) for n in lens], B * n_pages + 1,
                  page, n_pages)
    bt = _holes(full, offs, page, window) if holes else full
    if holes:
        assert (bt == -1).sum() > (full == -1).sum()

    def gather(table):
        return [p[np.maximum(table, 0)].reshape(B, n_pages * page, KV, D)
                for p in (kp, vp)]

    def port(table):
        t = [torch.from_numpy(_np(a)) for a in (q, *gather(table), offs,
                                                lens)]
        return tops.chunked_prefill_attention(
            t[0], t[1], t[2], q_offsets=t[3], kv_lens=t[4], window=window)
    q = rng.standard_normal((B, C, H, D), np.float32)
    got = port(bt)
    k, v = gather(bt)
    want = jops.chunked_prefill_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        q_offset=0, kv_len=n_pages * page, window=window,
        q_offsets=jnp.asarray(offs), kv_lens=jnp.asarray(lens),
        block_q=C, block_k=64, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)
    assert (got[B - 1] == 0).all()
    # the holes are dead: the table without them gives the same output
    assert torch.equal(got, port(full))


@pytest.mark.parametrize("quant", [False, True])
def test_plain_decode_d256_holes_vs_pallas(quant):
    """Decode through the block table at D 256 with -1 holes mid-table
    and a fully masked row, in f32 pages and in int8 pages with bf16
    scales (the Pallas kernel's ``_kernel_quant``)."""
    B, H, KV, D, page, n_pages = 4, 4, 2, 256, 16, 8
    rng = np.random.default_rng(1)
    P = B * n_pages + 2
    kp, vp = _pages(rng, P, page, KV, D)
    lens = np.array([128, 57, 1, 90], np.int32)
    bt = _table(rng, lens, P, page, n_pages)
    bt[0, 2] = bt[3, 0] = -1
    bt[2] = -1
    q = rng.standard_normal((B, H, D), np.float32)
    kw_j, kw_t = {}, {}
    if quant:
        k8 = rng.integers(-127, 128, kp.shape).astype(np.int8)
        v8 = rng.integers(-127, 128, vp.shape).astype(np.int8)
        ks = (0.02 * rng.random(kp.shape[:3]) + 1e-3).astype(np.float32)
        vs = (0.02 * rng.random(kp.shape[:3]) + 1e-3).astype(np.float32)
        kp, vp = k8, v8
        kw_j = dict(k_scales=jnp.asarray(ks).astype(jnp.bfloat16),
                    v_scales=jnp.asarray(vs).astype(jnp.bfloat16))
        kw_t = dict(k_scales=torch.from_numpy(ks).to(torch.bfloat16),
                    v_scales=torch.from_numpy(vs).to(torch.bfloat16))
    got = tops.paged_attention(*(torch.from_numpy(_np(a)) for a in
                                 (q, kp, vp, bt, lens)), **kw_t)
    want = jops.paged_attention(*(jnp.asarray(a) for a in
                                  (q, kp, vp, bt, lens)), **kw_j,
                                interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)
    assert (got[2] == 0).all()


# ---------------------------------------------------------------- configs

SERVED = [a for a in ARCH_IDS if a not in NOT_PORTED]


@pytest.mark.parametrize("shape", [None, "long_500k"])
@pytest.mark.parametrize("arch", SERVED)
def test_get_config_equals_the_jax_registry(arch, shape):
    want = jax_get_config(arch, shape)
    got = get_config(arch, shape)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_long_500k_turns_every_full_attention_layer_into_a_window():
    cfg = get_config("llama3.2-3b", "long_500k")
    assert {(l.mixer, l.window) for l in cfg.layers} == {(SWA, 8192)}
    assert cfg.attn_variant == "swa_500k"
    gemma = get_config("gemma3-4b", "long_500k")
    assert gemma is get_config("gemma3-4b")    # not in SWA_500K_ARCHS
    assert sum(l.mixer == ATTN for l in gemma.layers) == 5
    assert {l.window for l in gemma.layers if l.mixer == SWA} == {1024}
    assert gemma.head_dim == 256


# ---------------------------------------------------------------- engines

class _FixedClock:
    """A constant iteration time, so both replicas schedule alike
    (tests/test_torch_engine.py's shim); records each plan."""

    def __init__(self, inner):
        self.inner = inner
        self.plans = []

    def execute(self, plan, now):
        self.plans.append((
            tuple((r.rid, c) for r, c in plan.prefill),
            tuple(r.rid for r in plan.decode)))
        self.inner.execute(plan, now)
        return 0.05

    def __getattr__(self, name):
        return getattr(self.inner, name)


def _configs(name):
    """(JAX, port) reduced configs: ``gemma`` keeps a sliding-window
    (window 64) and a global layer; ``llama-500k`` is llama3.2-3b's
    swa_500k variant, every layer sliding (window clamped to 64)."""
    arch, shape = {"gemma": ("gemma3-4b", None),
                   "llama-500k": ("llama3.2-3b", "long_500k")}[name]
    jc = jax_get_config(arch, shape).reduced(num_layers=2, d_model=128)
    tc = get_config(arch, shape).reduced(num_layers=2, d_model=128)
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    return jc, tc


def _requests(req_cls, qos_cls):
    """Four requests through two slots; prompts and outputs long enough
    that every window (64) slides."""
    qos = qos_cls("q", interactive=True, ttft_slo=1e6, tbt_slo=1e6)
    return [req_cls(rid=i, arrival=0.15 * i, prompt_len=40 + 23 * i,
                    decode_len=12 + 5 * (i % 3), qos=qos, app_id="a")
            for i in range(4)]


@pytest.mark.parametrize("name", ["gemma", "llama-500k"])
def test_replica_streams_equal_jax_replica(name):
    jc, tc = _configs(name)
    kw = dict(n_slots=2, max_len=192, block_size=16, quantum=16, seed=5)
    jrep = make_jax_replica("niyama", jc, backend_wrap=_FixedClock, **kw)
    sd = bridge.params_from_numpy(
        jax.tree.map(np.asarray, jrep.backend.inner.params))
    trep = make_torch_replica("niyama", tc, device="cpu", params=sd,
                              backend_wrap=_FixedClock, **kw)
    for rep, req_cls, qos_cls in ((jrep, JRequest, JQoS),
                                  (trep, TRequest, TQoS)):
        rep.submit_all(_requests(req_cls, qos_cls))
        rep.run()
        assert len(rep.finished) == 4
    jeng, teng = jrep.backend.inner, trep.backend.inner
    assert trep.backend.plans == jrep.backend.plans
    assert teng.generated == jeng.generated
    assert teng.gather_bucket_hits == jeng.gather_bucket_hits
    assert teng._swa_reclaim_window == jeng._swa_reclaim_window
    assert teng.kv_blocks_reclaimed == jeng.kv_blocks_reclaimed
    if name == "llama-500k":
        assert teng.kv_blocks_reclaimed > 0
    else:
        assert teng._swa_reclaim_window is None


def _mixed_plan(cfg, rng, holes: bool, n_slots=4):
    """A fused iteration whose positions reach past the window (64):
    prefill rows at offsets 0 and 90 (one resuming), two pad rows; four
    decode slots, two active at 100 and 37 tokens. With ``holes`` the
    rows' dead leading blocks are -1, as reclamation left them after the
    iteration before (``_holes``)."""
    bs, maxb = 16, 8
    pre_tokens = rng.integers(0, cfg.vocab_size, (4, 32)).astype(np.int32)
    pre_slots = np.array([0, 1, n_slots, n_slots], np.int32)
    pre_reset = np.array([True, False, False, False])
    pre_start = np.array([0, 90, 0, 0], np.int32)
    pre_len = np.array([20, 30, 0, 0], np.int32)
    pre_sample = np.array([19, 29, 0, 0], np.int32)
    ids = rng.permutation(4 * maxb).astype(np.int32)
    pre_bt = np.full((4, maxb), -1, np.int32)
    pre_bt[0, :2] = ids[:2]
    pre_bt[1, :8] = ids[2:10]
    dec_tokens = rng.integers(0, cfg.vocab_size, n_slots).astype(np.int32)
    dec_start = np.array([0, 16, 100, 37], np.int32)
    dec_active = np.array([False, False, True, True])
    dec_bt = np.full((n_slots, maxb), -1, np.int32)
    dec_bt[2, :7] = ids[10:17]
    dec_bt[3, :3] = ids[17:20]
    if holes:
        pre_bt = _holes(pre_bt, pre_start, bs, 64)
        dec_bt = _holes(dec_bt, dec_start, bs, 64)
        assert pre_bt[1, 0] == dec_bt[2, 0] == -1
    return (pre_tokens, pre_slots, pre_start, pre_len, pre_reset,
            pre_sample, dec_tokens, dec_start, dec_active, pre_bt,
            dec_bt), np.r_[pre_len > 0, dec_active]


def _jax_hidden(params, cfg, cache, attn_impl, pre_tokens, pre_slots,
                pre_start, pre_len, pre_reset, pre_sample, dec_tokens,
                dec_start, dec_active, pre_bt, dec_bt):
    """JAX's fused_serve_forward stopped before its LM head."""
    P, L = pre_tokens.shape
    x_pre = JT._embed(params, cfg, pre_tokens, None)
    x_dec = JT._embed(params, cfg, dec_tokens[:, None], None)
    pre_valid = jnp.arange(L)[None, :] < pre_len[:, None]
    for li, spec in enumerate(cfg.layers):
        x_pre, x_dec, _ = JT._fused_block(
            params["layers"][li], cfg, spec, x_pre, x_dec,
            cache["layers"][li], pre_slots, pre_start, pre_len, pre_reset,
            pre_valid, dec_start, dec_active, JT._identity_shard,
            attn_impl, pre_bt=pre_bt, dec_bt=dec_bt)
    x_pre = JL.rmsnorm(x_pre, params["final_norm"], cfg.norm_eps)
    x_dec = JL.rmsnorm(x_dec, params["final_norm"], cfg.norm_eps)
    return jnp.concatenate([x_pre[jnp.arange(P), pre_sample], x_dec[:, 0]])


@pytest.mark.parametrize("attn_impl", ["jnp", "pallas"])
@pytest.mark.parametrize("name", ["gemma", "llama-500k"])
def test_fused_hidden_states_match_jax(name, attn_impl):
    """Stale KV in every page; the all-sliding config's tables carry
    -1 holes over its dead blocks (a global layer would read them)."""
    jc, tc = _configs(name)
    rng = np.random.default_rng(2)
    jp = JT.init_params(jax.random.PRNGKey(3), jc)
    model = TT.Transformer(tc, "cpu", torch.float32)
    model.load_state_dict(bridge.params_from_numpy(
        jax.tree.map(np.asarray, jp)), strict=True)
    jcache = JT.init_paged_cache(jc, 4, 32, 16)
    jcache = jax.tree.map(
        lambda a: jnp.asarray(rng.standard_normal(a.shape, np.float32)),
        jcache)
    arrs, live = _mixed_plan(tc, rng, holes=name == "llama-500k")
    jarrs = [jnp.asarray(a) for a in arrs]
    want_ids, _ = JT.fused_serve_forward(
        jp, jc, jcache, *jarrs[:9], pre_bt=jarrs[9], dec_bt=jarrs[10],
        attn_impl=attn_impl)
    want = np.asarray(_jax_hidden(jp, jc, jcache, attn_impl, *jarrs))
    host = jax.tree.map(np.asarray, jcache)
    tarrs = [torch.from_numpy(a) for a in arrs]
    tops.reset_counts()
    with torch.inference_mode():
        hid = TT._sampled_hidden(
            model, tc, bridge.paged_cache_from_numpy(host, device="cpu"),
            *tarrs)
    ids = TT.fused_serve_forward(
        model, tc, bridge.paged_cache_from_numpy(host, device="cpu"),
        *tarrs)
    np.testing.assert_allclose(hid.numpy()[live], want[live], rtol=HIDDEN,
                               atol=HIDDEN)
    np.testing.assert_array_equal(ids.numpy()[live],
                                  np.asarray(want_ids)[live])
    # decode rows of a sliding layer read through the prefill version
    n_full = sum(l.mixer == ATTN for l in tc.layers)
    counts = tops.counts()
    assert counts["paged_attention"]["plain"] == 2 * n_full
    assert counts["chunked_prefill_attention"]["plain"] == \
        2 * (len(tc.layers) + len(tc.layers) - n_full)
    tops.reset_counts()


# ---------------------------------------------------------------- reclaim

QOS = dict(interactive=True, ttft_slo=1e6, tbt_slo=1e6)


def _all_swa(cfg):
    """The reduced gemma with its global layer swapped for a second
    sliding one (window 64), as tests/test_swa_reclaim.py builds it."""
    swa = next(l for l in cfg.layers if l.mixer == SWA)
    return dataclasses.replace(cfg, layers=tuple(
        swa if l.mixer == ATTN else l for l in cfg.layers))


def _pair(cfg_name, seed, **kw):
    """A JaxEngine and a TorchEngine (CPU, the JAX engine's weights) on
    the two packages' configs."""
    jc = jax_get_config(cfg_name).reduced(num_layers=2, d_model=128)
    tc = get_config(cfg_name).reduced(num_layers=2, d_model=128)
    if kw.pop("all_swa", False):
        jc, tc = _all_swa(jc), _all_swa(tc)
    args = dict(n_slots=2, max_len=128, quantum=16, seed=seed,
                block_size=32)
    jeng = JaxEngine(jc, kv_layout="paged", **args)
    sd = bridge.params_from_numpy(jax.tree.map(np.asarray, jeng.params))
    teng = TorchEngine(tc, params=sd, device="cpu", **args)
    return jeng, teng


def test_reclaim_gate_requires_all_swa():
    for arch, all_swa, want in (("llama3.2-3b", False, None),
                                ("gemma3-4b", False, None),
                                ("gemma3-4b", True, 64)):
        jeng, teng = _pair(arch, 0, all_swa=all_swa)
        assert jeng._swa_reclaim_window == teng._swa_reclaim_window == want
        assert teng.kv_blocks_reclaimed == 0


def _drive(eng, plan_cls, req_cls, qos_cls, probe=None):
    """tests/test_swa_reclaim.py's scenario: r0 prefills 90 tokens and
    decodes across the point where its leading block dies; r1 is
    admitted after the reclaim; both decode together. ``probe(eng,
    step)`` runs after each named step."""
    qos = qos_cls("q", **QOS)
    probe = probe or (lambda e, s: None)
    r0 = req_cls(rid=0, arrival=0.0, prompt_len=90, decode_len=10, qos=qos)
    eng.on_admit(r0)
    eng.execute(plan_cls(prefill=[(r0, 90)]), 0.0)
    r0.prefilled = 90
    probe(eng, "prefilled")
    for _ in range(5):
        eng.execute(plan_cls(decode=[r0]), 0.0)
    probe(eng, "shed")
    r1 = req_cls(rid=1, arrival=0.0, prompt_len=40, decode_len=3, qos=qos)
    eng.on_admit(r1)
    eng.execute(plan_cls(prefill=[(r1, 40)]), 0.0)
    r1.prefilled = 40
    probe(eng, "admitted")
    for _ in range(3):
        eng.execute(plan_cls(decode=[r0, r1]), 0.0)
    for _ in range(2):
        eng.execute(plan_cls(decode=[r0]), 0.0)
    probe(eng, "done")
    eng.on_release(r0)
    eng.on_release(r1)


def test_swa_decode_sheds_blocks_with_concurrent_reuse():
    """A decode sheds its leading block mid-stream, a request admitted
    after the reclaim holds the freed physical id, and both streams,
    the reclaim count and every block table along the way equal
    JaxEngine's."""
    jeng, teng = _pair("gemma3-4b", 7, all_swa=True)
    seen = {}

    def probe(name):
        def fn(eng, step):
            seen[name, step] = ({r: list(eng.pool.block_table(r))
                                 for r in (0, 1)},
                                eng.kv_blocks_reclaimed, eng.pool.free)
            if name == "torch" and step == "prefilled":
                seen["first"] = eng.pool.block_table(0)[0]
        return fn
    _drive(jeng, JPlan, JRequest, JQoS, probe("jax"))
    _drive(teng, TPlan, TRequest, TQoS, probe("torch"))
    for step in ("prefilled", "shed", "admitted", "done"):
        assert seen["torch", step] == seen["jax", step], step
    tables, reclaimed, _ = seen["torch", "shed"]
    assert reclaimed >= 1 and tables[0][0] == -1
    first = seen["first"]
    assert first >= 0
    assert first in seen["torch", "admitted"][0][1]
    assert teng.generated == jeng.generated
    assert len(teng.generated[0]) == 11 and len(teng.generated[1]) == 4


def test_swa_prefill_phase_reclaim():
    """A prompt longer than window + block sheds its head in the prefill
    bookkeeping (the same formula, len = prefilled + chunk), and decodes
    on as JAX's engine does."""
    jeng, teng = _pair("gemma3-4b", 3, all_swa=True)
    for eng, plan_cls, req_cls, qos_cls in ((jeng, JPlan, JRequest, JQoS),
                                            (teng, TPlan, TRequest, TQoS)):
        r = req_cls(rid=0, arrival=0.0, prompt_len=100, decode_len=3,
                    qos=qos_cls("q", **QOS))
        eng.on_admit(r)
        eng.execute(plan_cls(prefill=[(r, 100)]), 0.0)
        r.prefilled = 100
        assert eng.kv_blocks_reclaimed == 1      # (100 - 64 + 1) // 32
        assert eng.pool.block_table(0)[0] == -1
        for _ in range(3):
            eng.execute(plan_cls(decode=[r]), 0.0)
        eng.on_release(r)
    assert teng.kv_blocks_reclaimed == jeng.kv_blocks_reclaimed
    assert teng.generated == jeng.generated
