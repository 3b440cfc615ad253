"""The KV hierarchy in the port: the copied ``serving/kvcache`` decides as
the JAX package's, and ``TorchEngine``'s pool hooks carry its swap tier,
its prefix tier and cross-engine transfers on real pages, in fp32 and
with int8 pages.

Within the port the contracts of tests/test_fused_engine.py hold bit for
bit on the CPU: a request swapped to host memory mid-decode, relegated
at the shared-prefix boundary or relegated mid-prefill streams exactly
the tokens of an uninterrupted run of the same engine, and shared-prefix
serving streams what serving without the cache streams. Against JAX, the
token streams are equal on the same weights (through ``bridge``) and the
same plans (the fixed-clock shim): the port's shared-prefix replica
against ``make_jax_replica``'s, and a request that a ``JaxEngine`` swaps
out and exports, landed in a ``TorchEngine``, against the JAX engine's
uninterrupted stream. The int8 runs hold JAX's int8 engine with the
Pallas decode kernel, whose fp32 dequantization the port's decode
mirrors.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core import kvpool as jkvpool  # noqa: E402
from repro.core.predictor import ModelCostModel as JCost  # noqa: E402
from repro.core.qos import QoSSpec as JQoS  # noqa: E402
from repro.core.request import Request as JRequest  # noqa: E402
from repro.core.scheduler import BatchPlan as JPlan  # noqa: E402
from repro.core.scheduler import NiyamaConfig as JNiyamaConfig  # noqa: E402
from repro.core.scheduler import NiyamaScheduler as JNiyama  # noqa: E402
from repro.engine.jax_backend import JaxEngine  # noqa: E402
from repro.serving import kvcache as jkvc  # noqa: E402
from repro.serving.replica import Replica as JReplica  # noqa: E402
from repro.serving.schemes import CPU_HW as J_CPU_HW  # noqa: E402
from repro.serving.schemes import make_jax_replica  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import kvpool as tkvpool  # noqa: E402
from repro_torch.core.predictor import ModelCostModel as TCost  # noqa: E402
from repro_torch.core.qos import QoSSpec as TQoS  # noqa: E402
from repro_torch.core.request import Request as TRequest  # noqa: E402
from repro_torch.core.scheduler import BatchPlan as TPlan  # noqa: E402
from repro_torch.core.scheduler import \
    NiyamaConfig as TNiyamaConfig  # noqa: E402
from repro_torch.core.scheduler import NiyamaScheduler as TNiyama  # noqa: E402
from repro_torch.engine.torch_backend import TorchEngine  # noqa: E402
from repro_torch.serving import kvcache as tkvc  # noqa: E402
from repro_torch.serving.replica import Replica as TReplica  # noqa: E402
from repro_torch.serving.schemes import CPU_HW as T_CPU_HW  # noqa: E402
from repro_torch.serving.schemes import make_torch_replica  # noqa: E402

QUANT = [pytest.param(False, id="f32"), pytest.param(True, id="int8")]
BS = 32


def _cfgs():
    return (jax_get_config("llama3.2-3b").reduced(num_layers=2, d_model=128),
            get_config("llama3.2-3b").reduced(num_layers=2, d_model=128))


def _qos(cls):
    return cls("q", interactive=True, ttft_slo=1e6, tbt_slo=1e6)


# ------------------------------------------------ the copied hierarchy

def _state(kv):
    """Everything the hierarchy decides with, in comparable form."""
    p = kv.prefix
    return dict(
        owned=dict(kv._owned), shared=dict(kv._shared),
        tables={r: tuple(t) for r, t in kv._tables.items()},
        free_ids=list(kv._free_ids), next_id=kv._next_id,
        tver=dict(kv._tver), swapped=dict(kv._swapped),
        hashes=dict(kv._hashes), host=dict(kv.host._held),
        host_moves=(kv.host.swap_outs, kv.host.swap_ins),
        blocks={h: (b.refs, b.last_used, b.phys)
                for h, b in p.blocks.items()},
        evictable=list(p._evictable), clock=p._clock,
        prefix_counts=(p.hit_tokens, p.miss_tokens, p.evictions,
                       p.insertions),
        sizes=(kv.used, kv.free, kv.raw_free),
        bytes=(kv.swapped_out_bytes_total, kv.swapped_in_bytes_total))


def test_copied_hierarchy_decides_as_jax_under_random_ops():
    """The operation mix of tests/test_kvcache.py::
    test_hierarchy_random_ops_conserve_blocks, applied to the JAX
    hierarchy and to the port's copy side by side: every return value
    and the whole accounting state agree after every step."""
    rng = np.random.default_rng(1)
    bulk = dict(interactive=False, ttlt_slo=600.0)
    kvs = [mod.KVHierarchy(48, 256, cfg=mod.KVCacheConfig(
        enable_prefix=True, enable_swap=True), bytes_per_block=1 << 20,
        host_blocks=32) for mod in (jkvc, tkvc)]
    live = {}                       # rid -> (JAX request, port request)
    next_rid = 0
    for step in range(600):
        op = rng.random()
        if op < 0.35 or not live:
            tenant = int(rng.integers(0, 4))
            prompt = int(rng.integers(300, 3000))
            pair = tuple(
                req_cls(rid=next_rid, arrival=0.0, prompt_len=prompt,
                        decode_len=4, qos=qos_cls("bulk", **bulk),
                        prefix_id=tenant, prefix_len=1000)
                for req_cls, qos_cls in ((JRequest, JQoS),
                                         (TRequest, TQoS)))
            next_rid += 1
            for kv, req in zip(kvs, pair):
                kv.attach(req)
            live[pair[0].rid] = pair
        elif op < 0.75:
            pair = live[int(rng.choice(list(live)))]
            take = min(pair[0].prefill_remaining, int(rng.integers(1, 900)))
            if take <= 0:
                continue
            rid = pair[0].rid
            if kvs[0].swapped_tokens(rid):
                if kvs[0].host.held(rid) > kvs[0].free:
                    continue
                for kv in kvs:
                    kv.swap_in(rid)
            grown = [kv.grow(rid, req.prefilled + take)
                     for kv, req in zip(kvs, pair)]
            assert grown[0] == grown[1]
            if grown[0]:
                for kv, req in zip(kvs, pair):
                    req.prefilled += take
                    kv.promote(rid, req.prefilled)
        elif op < 0.87:
            pair = live[int(rng.choice(list(live)))]
            for kv, req in zip(kvs, pair):
                req.prefilled = kv.on_relegate(req.rid, req.prefilled)
        else:
            rid = int(rng.choice(list(live)))
            for kv in kvs:
                kv.release(rid)
            del live[rid]
        j, t = _state(kvs[0]), _state(kvs[1])
        assert j == t, f"step {step}: " + ", ".join(
            k for k in j if j[k] != t[k])
        for jr, tr in live.values():
            assert (jr.prefilled, jr.cache_hit_tokens) \
                == (tr.prefilled, tr.cache_hit_tokens)


# ------------------------------------------------ the engine's hooks

def _hierarchy(tc, kv_quant, prefix=False, swap=True, blocks=8):
    return tkvc.KVHierarchy(
        blocks, BS, cfg=tkvc.KVCacheConfig(enable_prefix=prefix,
                                           enable_swap=swap),
        bytes_per_block=tkvpool.kv_bytes_per_block(tc, BS,
                                                   kv_quant=kv_quant),
        max_seqs=2)


def _engine(tc, kv_quant, pool=None, **kw):
    return TorchEngine(tc, n_slots=2, max_len=128, quantum=16, seed=7,
                       block_size=BS, pool=pool, device="cpu",
                       kv_quant=kv_quant, **kw)


def _req(rid=0, prompt=40, decode=6, **kw):
    return TRequest(rid=rid, arrival=0.0, prompt_len=prompt,
                    decode_len=decode, qos=_qos(TQoS), **kw)


@pytest.mark.parametrize("kv_quant", QUANT)
def test_swap_out_and_back_mid_decode_bit_identical(kv_quant):
    """A request swapped to host memory mid-decode (its private pages,
    scale pages included, copied out; its blocks freed and churned by
    another request; then re-granted) streams exactly what an
    uninterrupted run of the same engine streams."""
    _, tc = _cfgs()
    base = _engine(tc, kv_quant)
    r = _req()
    base.on_admit(r)
    base.execute(TPlan(prefill=[(r, 40)]), 0.0)
    r.prefilled = 40
    for _ in range(5):
        base.execute(TPlan(decode=[r]), 0.0)

    kv = _hierarchy(tc, kv_quant)
    eng = _engine(tc, kv_quant, pool=kv, params=base.params.state_dict())
    r = _req()
    eng.on_admit(r)
    eng.execute(TPlan(prefill=[(r, 40)]), 0.0)
    r.prefilled = 40
    for _ in range(2):
        eng.execute(TPlan(decode=[r]), 0.0)
    held = list(kv.block_table(r.rid))
    assert kv.on_relegate(r.rid, 42) == 42   # prompt 40 + 2 decoded
    eng.on_release(r)
    assert kv.swapped_tokens(r.rid) == 42
    assert kv.private_blocks(r.rid) == 0     # the blocks really freed
    saved = eng._swap_store[r.rid]["pages"][0]
    assert len(saved) == (4 if kv_quant else 2)
    assert all(t.device.type == "cpu" and t.shape[0] == len(held)
               for t in saved)
    other = _req(rid=9, prompt=33, decode=2)
    eng.on_admit(other)
    kv.grow(9, 33)
    assert set(kv.block_table(9)) & set(held)   # churns r's old blocks
    eng.execute(TPlan(prefill=[(other, 33)]), 0.0)
    other.prefilled = 33
    eng.execute(TPlan(decode=[other]), 0.0)
    eng.on_release(other)
    kv.release(9)
    for _ in range(3):
        eng.execute(TPlan(decode=[r]), 0.0)     # swap-resume in execute
    assert eng.generated[0] == base.generated[0]
    assert r.rid not in eng._swap_store


def _uninterrupted(tc, kv_quant, chunks, decodes, params, **req_kw):
    eng = _engine(tc, kv_quant, params=params)
    r = _req(**req_kw)
    eng.on_admit(r)
    for c in chunks:
        eng.execute(TPlan(prefill=[(r, c)]), 0.0)
        r.prefilled += c
    for _ in range(decodes):
        eng.execute(TPlan(decode=[r]), 0.0)
    return eng.generated[0]


@pytest.mark.parametrize("kv_quant", QUANT)
def test_relegation_at_the_shared_boundary_resumes(kv_quant):
    """A request relegated when its whole resident state is shared prefix
    pages (nothing private, so nothing goes to the host tier) resumes off
    the pinned cache pages (test_fused_engine.py:169)."""
    _, tc = _cfgs()
    kv = _hierarchy(tc, kv_quant, prefix=True)
    eng = _engine(tc, kv_quant, pool=kv)
    want = _uninterrupted(tc, kv_quant, (64, 16), 2,
                          eng.params.state_dict(), prompt=80, decode=3,
                          prefix_id=5, prefix_len=64)
    r = _req(prompt=80, decode=3, prefix_id=5, prefix_len=64)
    kv.attach(r)
    assert r.prefilled == 0                 # cold cache
    eng.on_admit(r)
    eng.execute(TPlan(prefill=[(r, 64)]), 0.0)
    r.prefilled = 64
    kv.promote(r.rid, 64)                   # both blocks published
    assert kv.private_blocks(r.rid) == 0
    r.prefilled = kv.on_relegate(r.rid, 64)
    assert r.prefilled == 64                # kept, nothing hosted
    assert kv.swapped_tokens(r.rid) == 0
    eng.on_release(r)
    eng.execute(TPlan(prefill=[(r, 16)]), 0.0)    # resumes at 64
    r.prefilled = 80
    for _ in range(2):
        eng.execute(TPlan(decode=[r]), 0.0)
    assert eng.generated[0] == want


@pytest.mark.parametrize("kv_quant", QUANT)
def test_preserving_relegation_mid_prefill(kv_quant):
    """Relegation with the swap tier keeps the prefilled tokens: the
    resumed prefill continues where it stopped (test_fused_engine.py:215)."""
    _, tc = _cfgs()
    kv = _hierarchy(tc, kv_quant)
    eng = _engine(tc, kv_quant, pool=kv)
    want = _uninterrupted(tc, kv_quant, (24, 16), 2,
                          eng.params.state_dict(), decode=3)
    r = _req(decode=3)
    eng.on_admit(r)
    kv.grow(0, 24)
    eng.execute(TPlan(prefill=[(r, 24)]), 0.0)
    r.prefilled = kv.on_relegate(r.rid, 24)    # swap-out mid-prefill
    assert r.prefilled == 24
    eng.on_release(r)
    eng.execute(TPlan(prefill=[(r, 16)]), 0.0)    # resumes at 24
    r.prefilled = 40
    for _ in range(2):
        eng.execute(TPlan(decode=[r]), 0.0)
    assert eng.generated[0] == want


@pytest.mark.parametrize("kv_quant", QUANT)
def test_promote_dedup_repoints_the_cached_block_table(kv_quant):
    """Two requests prefill the same prefix before either publishes it;
    the second's ``promote`` frees its copies and repoints its table at
    the first's pages. The engine's cached device table (keyed on the
    pool's ``table_version``) must follow in the very next iteration,
    whose shapes and rids match the last: the freed copies are then
    overwritten, and the stream still equals a run without the cache."""
    _, tc = _cfgs()
    bs = 16
    kv = tkvc.KVHierarchy(16, bs, cfg=tkvc.KVCacheConfig(
        enable_prefix=True), max_seqs=2)
    eng = TorchEngine(tc, n_slots=2, max_len=128, quantum=16, seed=7,
                      pool=kv, device="cpu", kv_quant=kv_quant)
    cold = TorchEngine(tc, n_slots=2, max_len=128, quantum=16, seed=7,
                       block_size=bs, device="cpu", kv_quant=kv_quant,
                       params=eng.params.state_dict())
    a, b = (_req(rid=i, prompt=60, decode=3, prefix_id=3, prefix_len=48)
            for i in (0, 1))
    for r in (a, b):
        kv.attach(r)
        assert r.prefilled == 0             # neither is published yet
    eng.execute(TPlan(prefill=[(a, 40)]), 0.0)
    a.prefilled = 40
    kv.promote(a.rid, 40)                   # a publishes blocks 0-1
    eng.execute(TPlan(prefill=[(b, 40)]), 0.0)
    b.prefilled = 40
    mine = list(kv.block_table(b.rid))
    ver = kv.table_version(b.rid)
    kv.promote(b.rid, 40)                   # dedup: b repoints at a's
    table = list(kv.block_table(b.rid))
    assert table[:2] == list(kv.block_table(a.rid))[:2] != mine[:2]
    assert kv.table_version(b.rid) != ver
    for c in eng.cache["layers"]:           # scribble over b's old copies
        for t in c:
            t[mine[:2]] = 3
    eng.execute(TPlan(prefill=[(b, 8)]), 0.0)   # same P and maxb as before
    row = eng._pre_bt_dev[0].tolist()
    assert row[:3] == table
    b.prefilled = 48
    eng.execute(TPlan(prefill=[(b, 12)]), 0.0)
    b.prefilled = 60
    for _ in range(2):
        eng.execute(TPlan(decode=[b]), 0.0)
    rb = _req(rid=1, prompt=60, decode=3, prefix_id=3, prefix_len=48)
    cold.on_admit(rb)
    for c in (40, 8, 12):
        cold.execute(TPlan(prefill=[(rb, c)]), 0.0)
        rb.prefilled += c
    for _ in range(2):
        cold.execute(TPlan(decode=[rb]), 0.0)
    assert eng.generated[1] == cold.generated[1]


# ------------------------------------------------ shared prefix, stack

class _FixedClock:
    """The fixed-clock shim of tests/test_fused_engine.py: a constant
    iteration time, so that replicas with different engines make the
    same scheduling decisions."""

    def __init__(self, inner):
        self.inner = inner

    def execute(self, plan, now):
        self.inner.execute(plan, now)
        return 0.05

    def __getattr__(self, name):
        return getattr(self.inner, name)


KW = dict(n_slots=2, max_len=128, block_size=16, quantum=16, seed=5)


def _prefix_requests(req_cls, qos_cls, n=4):
    return [req_cls(rid=i, arrival=0.4 * i, prompt_len=70 + 3 * i,
                    decode_len=3 + (i % 3), qos=_qos(qos_cls), app_id="a",
                    prefix_id=77, prefix_len=64) for i in range(n)]


def _jax_int8_replica(jc, kv_cfg):
    """``make_jax_replica``'s pieces, with ``JaxEngine(kv_quant=True,
    attn_impl="pallas")`` (the factory has no int8 switch)."""
    n, L, bs = KW["n_slots"], KW["max_len"], KW["block_size"]
    nb = n * L // bs
    kv = jkvc.KVHierarchy(nb, bs, cfg=kv_cfg, bytes_per_block=(
        jkvpool.kv_bytes_per_block(jc, bs, bytes_per=4)), max_seqs=n) \
        if kv_cfg is not None else jkvpool.KVPool(nb, bs, max_seqs=n)
    eng = JaxEngine(jc, n_slots=n, max_len=L, quantum=KW["quantum"],
                    seed=KW["seed"], kv_layout="paged", pool=kv,
                    kv_quant=True, attn_impl="pallas")
    sched = JNiyama(JCost(jc, J_CPU_HW), cfg=JNiyamaConfig(
        max_chunk=L, quantum=KW["quantum"], fixed_chunk=64,
        max_decode_batch=n))
    return JReplica(scheduler=sched, backend=_FixedClock(eng), kv=kv)


def _torch_replica(tc, kv_cfg, kv_quant, params):
    """``make_torch_replica``, or for int8 its pieces with
    ``TorchEngine(kv_quant=True)``."""
    if not kv_quant:
        return make_torch_replica("niyama", tc, device="cpu", params=params,
                                  kv_cfg=kv_cfg, backend_wrap=_FixedClock,
                                  **KW)
    n, L, bs = KW["n_slots"], KW["max_len"], KW["block_size"]
    nb = n * L // bs
    kv = tkvc.KVHierarchy(nb, bs, cfg=kv_cfg, bytes_per_block=(
        tkvpool.kv_bytes_per_block(tc, bs, bytes_per=4)), max_seqs=n) \
        if kv_cfg is not None else tkvpool.KVPool(nb, bs, max_seqs=n)
    eng = TorchEngine(tc, n_slots=n, max_len=L, quantum=KW["quantum"],
                      seed=KW["seed"], pool=kv, params=params,
                      device="cpu", kv_quant=True)
    sched = TNiyama(TCost(tc, T_CPU_HW), cfg=TNiyamaConfig(
        max_chunk=L, quantum=KW["quantum"], fixed_chunk=64,
        max_decode_batch=n))
    return TReplica(scheduler=sched, backend=_FixedClock(eng), kv=kv)


def _run(rep, req_cls, qos_cls):
    rep.submit_all(_prefix_requests(req_cls, qos_cls))
    rep.run()
    assert len(rep.finished) == 4
    return rep.backend.inner


@pytest.mark.parametrize("kv_quant", QUANT)
def test_shared_prefix_through_the_stack(kv_quant):
    """Shared-prefix requests through the scheduler stack: later tenants'
    tables point at the first tenant's published pages, so fewer prefill
    tokens are dispatched, the streams equal serving without the cache,
    and both equal the JAX stack's on the same plans
    (test_fused_engine.py::
    test_scheduler_stack_shared_prefix_skips_prefill_and_bit_identical)."""
    jc, tc = _cfgs()
    if kv_quant:
        jrep = _jax_int8_replica(jc, jkvc.KVCacheConfig(enable_prefix=True))
    else:
        jrep = make_jax_replica("niyama", jc, backend_wrap=_FixedClock,
                                kv_cfg=jkvc.KVCacheConfig(
                                    enable_prefix=True), **KW)
    jeng = _run(jrep, JRequest, JQoS)
    sd = bridge.params_from_numpy(jax.tree.map(np.asarray, jeng.params))
    hot_rep = _torch_replica(tc, tkvc.KVCacheConfig(enable_prefix=True),
                             kv_quant, sd)
    hot = _run(hot_rep, TRequest, TQoS)
    cold = _run(_torch_replica(tc, None, kv_quant, sd), TRequest, TQoS)
    assert hot.kv_quant == kv_quant
    assert hot.generated == cold.generated
    assert hot.generated == jeng.generated
    assert hot.prefill_tokens < cold.prefill_tokens, \
        (hot.prefill_tokens, cold.prefill_tokens)
    assert hot.prefill_tokens == jeng.prefill_tokens
    kv = hot_rep.kv
    assert kv.prefix.hit_tokens > 0
    assert kv.used == kv.prefix.n_pinned == 0


# ------------------------------------------------ the cross-engine wire

@pytest.mark.parametrize("kv_quant", QUANT)
def test_jax_swap_payload_continues_in_the_torch_engine(kv_quant):
    """A ``JaxEngine`` swaps a request out mid-decode and exports it; the
    payload crosses through ``bridge.swap_payload_from_numpy`` into a
    ``TorchEngine`` on the same weights, which swaps it in and decodes on:
    the whole stream equals the JAX engine's uninterrupted one."""
    jc, tc = _cfgs()
    jkw = dict(n_slots=2, max_len=128, quantum=16, seed=7,
               kv_layout="paged", kv_quant=kv_quant,
               attn_impl="pallas" if kv_quant else "jnp")
    base = JaxEngine(jc, block_size=BS, **jkw)
    r = JRequest(rid=0, arrival=0.0, prompt_len=40, decode_len=6,
                 qos=_qos(JQoS))
    base.on_admit(r)
    base.execute(JPlan(prefill=[(r, 40)]), 0.0)
    r.prefilled = 40
    for _ in range(5):
        base.execute(JPlan(decode=[r]), 0.0)

    jkv = jkvc.KVHierarchy(8, BS, cfg=jkvc.KVCacheConfig(enable_swap=True),
                           bytes_per_block=jkvpool.kv_bytes_per_block(
                               jc, BS, kv_quant=kv_quant), max_seqs=2)
    src = JaxEngine(jc, pool=jkv, **jkw)
    r = JRequest(rid=0, arrival=0.0, prompt_len=40, decode_len=6,
                 qos=_qos(JQoS))
    src.on_admit(r)
    src.execute(JPlan(prefill=[(r, 40)]), 0.0)
    r.prefilled = 40
    for _ in range(2):
        src.execute(JPlan(decode=[r]), 0.0)
    assert jkv.on_relegate(0, 42) == 42
    src.on_release(r)
    payload = src.export_swapped(0)
    blocks, tokens = jkv.host.held(0), jkv.swapped_tokens(0)
    jkv.release(0)                          # detached at the source

    tkv = _hierarchy(tc, kv_quant)
    dst = _engine(tc, kv_quant, pool=tkv, params=bridge.params_from_numpy(
        jax.tree.map(np.asarray, src.params)))
    assert tkv.host_receive(0, blocks, tokens)
    wire = bridge.swap_payload_from_numpy(payload)
    pages = wire["swap"]["pages"][0]
    assert [t.dtype for t in pages] == (
        [torch.int8, torch.int8, torch.bfloat16, torch.bfloat16]
        if kv_quant else [torch.float32, torch.float32])
    dst.import_swapped(0, wire)
    tr = _req()
    tr.prefilled = 40
    for _ in range(3):
        dst.execute(TPlan(decode=[tr]), 0.0)
    assert len(dst.generated[0]) == 6
    assert dst.generated[0] == base.generated[0]


def test_serve_script_prefix_cache_flag():
    """``--prefix-cache`` gives the port's serve script the hierarchy's
    shared-prefix tier, as in the JAX serve script."""
    from repro_torch.launch import serve
    rep = serve.main(["--device", "cpu", "--reduced", "--prefix-cache",
                      "--n-requests", "3"])
    assert isinstance(rep.kv, tkvc.KVHierarchy)
    assert rep.kv.cfg.enable_prefix and not rep.kv.cfg.enable_swap
    assert len(rep.finished) == 3
    assert rep.kv.used == rep.kv.prefix.n_pinned == 0
