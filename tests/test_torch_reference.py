"""The port's dense slot cache, its offline forward and its two other
engines against the JAX package's, and the port's four ways of serving
against each other.

Against JAX, on the same numpy inputs and the JAX weights carried across
by ``repro_torch.bridge`` (CPU, f32 unless stated):

- the attention functions of ``models/layers.py`` (``blocked_attention``
  causal and not, with and without a window; the banded
  ``swa_blocked_attention``; ``decode_attention``): within 2e-6 (XLA and
  ATen sum in different orders; measured up to 8.3e-7);
- ``init_cache`` and ``_write_cache`` in bf16 and int8, through a ring
  that wraps and with dropped writes: every live row bit-equal (the
  writes copy or quantize values; nothing is summed);
- ``prefill`` and ``decode_step``: logits within 1e-5, MoE families
  within 4e-6 (ROADMAP.md §3: the JAX MoE is not bit-stable);
- ``ReferenceTorchEngine`` against ``ReferenceJaxEngine`` through the
  plans of ``drive_plans`` (``tests/test_fused_engine.py``): equal
  streams on seven families;
- ``TorchEngine(kv_layout="dense")`` against ``JaxEngine(kv_layout=
  "dense", attn_impl="pallas")`` (the Pallas kernels in interpret
  mode, as the JAX tests run them): equal streams and shape buckets.

Inside the port: the fused engine in both layouts, the reference engine
and offline greedy decode give equal streams; the fused engine's final
hidden states are bit-equal between the layouts, and its logits equal
the reference engine's bit for bit, except for the Mamba2 family (the
fused prefill row is padded to its quantum bucket and the reference's is
not, and the plain SSD scan sums a padded row in another order: within
1e-6). Twins of ``tests/test_fused_engine.py:251``, ``:277`` and
``:422`` and of ``tests/test_serve_e2e.py:37``, and the serve script's
``--engine reference`` and ``--kv-layout dense``.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core.qos import QoSSpec as JQoS  # noqa: E402
from repro.core.request import Request as JRequest  # noqa: E402
from repro.core.scheduler import BatchPlan as JPlan  # noqa: E402
from repro.engine.jax_backend import (JaxEngine,  # noqa: E402
                                      ReferenceJaxEngine)
from repro.models import layers as JL  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.kvpool import KVPool  # noqa: E402
from repro_torch.core.predictor import ModelCostModel  # noqa: E402
from repro_torch.core.qos import QoSSpec  # noqa: E402
from repro_torch.core.request import Request  # noqa: E402
from repro_torch.core.scheduler import (BatchPlan, NiyamaConfig,  # noqa: E402
                                        NiyamaScheduler)
from repro_torch.engine.torch_backend import (ReferenceTorchEngine,  # noqa
                                              TorchEngine, make_engine)
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models.config import MOE  # noqa: E402
from repro_torch.serving.kvcache import KVCacheConfig  # noqa: E402
from repro_torch.serving.replica import Replica  # noqa: E402
from repro_torch.serving.schemes import CPU_HW, make_torch_replica  # noqa

ALL_FAMILIES = ["llama3.2-3b", "qwen3-moe-30b-a3b", "jamba-v0.1-52b",
                "mamba2-370m", "gemma3-4b", "whisper-medium",
                "internvl2-76b"]
# the decoder-only families the fused engine serves
FUSED_FAMILIES = [a for a in ALL_FAMILIES if a != "whisper-medium"]
I32 = dict(dtype=torch.int32)


def _configs(arch):
    """(JAX config, port config), ``.reduced(num_layers=2,
    d_model=128)``, the same fields in both packages."""
    jc = jax_get_config(arch).reduced(num_layers=2, d_model=128)
    tc = get_config(arch).reduced(num_layers=2, d_model=128)
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    return jc, tc


def _weights(jparams):
    return bridge.params_from_numpy(jax.tree.map(np.asarray, jparams))


def drive_plans(engine, req_cls, qos_cls, plan_cls):
    """The BatchPlan sequence of tests/test_fused_engine.py::drive_plans,
    built from either package's classes: multi-chunk prefill with a chunk
    == the fused engines' quantum, pure-prefill iterations, a prefill
    that completes while a decode batch is live, joint decode, and slot
    reuse after release. Returns rid -> stream length."""
    qos = qos_cls("q", interactive=True, ttft_slo=1e6, tbt_slo=1e6)
    r0 = req_cls(rid=0, arrival=0.0, prompt_len=40, decode_len=5, qos=qos)
    r1 = req_cls(rid=1, arrival=0.0, prompt_len=33, decode_len=4, qos=qos)
    engine.on_admit(r0)
    engine.on_admit(r1)
    engine.execute(plan_cls(prefill=[(r0, 24)]), 0.0)
    r0.prefilled = 24
    engine.execute(plan_cls(prefill=[(r0, 16)]), 0.0)   # completes r0
    r0.prefilled = 40
    # r1 completes its whole prefill WHILE r0 decodes
    engine.execute(plan_cls(prefill=[(r1, 33)], decode=[r0]), 0.0)
    r1.prefilled = 33
    for _ in range(3):
        engine.execute(plan_cls(decode=[r0, r1]), 0.0)
    engine.execute(plan_cls(decode=[r1]), 0.0)          # r0 done at 5
    engine.on_release(r0)
    engine.on_release(r1)
    r2 = req_cls(rid=2, arrival=0.0, prompt_len=21, decode_len=3, qos=qos)
    engine.on_admit(r2)
    engine.execute(plan_cls(prefill=[(r2, 21)]), 0.0)
    r2.prefilled = 21
    engine.execute(plan_cls(decode=[r2]), 0.0)
    engine.execute(plan_cls(decode=[r2]), 0.0)
    engine.on_release(r2)
    return {0: 5, 1: 5, 2: 3}


def _drive_torch(engine):
    return drive_plans(engine, Request, QoSSpec, BatchPlan)


def offline_greedy(engine, cfg, rid, n_tokens):
    """Straight ``prefill`` of the whole prompt and greedy
    ``decode_step``s with the engine's weights and prompt, on a cache of
    one row: the scheduling and batching machinery must be invisible in
    the outputs."""
    prompt = engine.tokens[rid]
    cache = TT.init_cache(cfg, 1, 128, dtype=torch.float32, chunk=128,
                          device="cpu")
    lg, cache = TT.prefill(engine.params, cfg, cache,
                           torch.as_tensor(prompt)[None],
                           torch.zeros((1,), **I32))
    toks = [int(torch.argmax(lg[0, -1, :cfg.vocab_size]))]
    for _ in range(n_tokens - 1):
        lg, cache = TT.decode_step(engine.params, cfg, cache,
                                   torch.tensor([[toks[-1]]], **I32))
        toks.append(int(torch.argmax(lg[0, 0, :cfg.vocab_size])))
    return toks


# ---------------------------------------------------------------- layers

@pytest.mark.parametrize("case", ["causal", "causal window", "bidirectional",
                                  "bidirectional window", "swa banded",
                                  "decode", "decode window"])
def test_attention_functions_match_jax(case):
    rng = np.random.default_rng(0)
    B, Sq, H, KV, D, Sk = 2, 40, 6, 2, 32, 100
    q = rng.standard_normal((B, Sq, H, D), np.float32)
    k = rng.standard_normal((B, Sk, KV, D), np.float32)
    v = rng.standard_normal((B, Sk, KV, D), np.float32)
    kl = np.array([90, 60], np.int32)
    t = torch.from_numpy
    j = (jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    p = (t(q), t(k), t(v))
    window = 16 if "window" in case or case == "swa banded" else None
    if case.startswith("decode"):
        want = JL.decode_attention(j[0][:, :1], *j[1:],
                                   kv_len=jnp.asarray(kl), window=window)
        got = TL.decode_attention(p[0][:, :1], *p[1:], kv_len=t(kl),
                                  window=window)
    elif case == "swa banded":
        # Sk > window + block: each stripe reads its clipped band
        want = JL.swa_blocked_attention(*j, q_offset=50,
                                        kv_len=jnp.asarray(kl),
                                        window=window, block_q=8)
        got = TL.swa_blocked_attention(*p, q_offset=50, kv_len=t(kl),
                                       window=window, block_q=8)
    else:
        causal = case.startswith("causal")
        want = JL.blocked_attention(*j, q_offset=30, kv_len=jnp.asarray(kl),
                                    causal=causal, window=window,
                                    block_q=16)
        got = TL.blocked_attention(*p, q_offset=30, kv_len=t(kl),
                                   causal=causal, window=window, block_q=16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=2e-6)


# ---------------------------------------------------------------- caches

@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
def test_write_cache_matches_jax_through_ring_and_drops(quant):
    """Three writes into gemma3-4b's reduced slot cache (a sliding-window
    layer's ring of 80 positions and a global layer's 128), rows wrapping
    the ring, with ``valid`` masks dropping tokens: every field of every
    live row equals JAX's bit for bit; the port's dropped writes land in
    the sink row only."""
    jc, tc = _configs("gemma3-4b")
    B, max_len, chunk = 3, 128, 16
    jcache = JT.init_cache(jc, B, max_len, dtype=jnp.bfloat16, chunk=chunk,
                           kv_quant=quant)
    tcache = TT.init_cache(tc, B, max_len, dtype=torch.bfloat16,
                           chunk=chunk, kv_quant=quant, device="cpu")
    assert [c.k.shape[1] for c in tcache["layers"]] == [80, 128]
    rng = np.random.default_rng(2)
    shape = (B, chunk, tc.num_kv_heads, tc.head_dim)
    for start, drop in (([0, 5, 60], None),
                        ([70, 21, 100], [[0] * 16, [1] * 16, [0] * 16]),
                        ([86, 37, 116], [[0] * 10 + [1] * 6, [0] * 16,
                                         [1] * 16])):
        kn = rng.standard_normal(shape, np.float32)
        vn = rng.standard_normal(shape, np.float32)
        sp = np.asarray(start, np.int32)
        valid = None if drop is None else ~np.asarray(drop, bool)
        for li in range(2):
            jcache["layers"][li] = JT._write_cache(
                jcache["layers"][li], jnp.asarray(kn), jnp.asarray(vn),
                jnp.asarray(sp),
                valid=None if valid is None else jnp.asarray(valid))
            TT._write_cache(tcache["layers"][li], torch.from_numpy(kn),
                            torch.from_numpy(vn), torch.from_numpy(sp),
                            valid=None if valid is None
                            else torch.from_numpy(valid))
    for jl, tl in zip(jcache["layers"], tcache["layers"]):
        assert type(tl).__name__ == type(jl).__name__
        for name in jl._fields:
            want = np.asarray(getattr(jl, name))
            got = getattr(tl, name)[:B]
            if got.dtype == torch.bfloat16:
                got = got.float()
                want = want.astype(np.float32)
            np.testing.assert_array_equal(got.numpy(), want, err_msg=name)


# ---------------------------------------------------------------- offline

@pytest.mark.parametrize("arch", ["llama3.2-3b", "qwen3-moe-30b-a3b",
                                  "jamba-v0.1-52b", "mamba2-370m",
                                  "gemma3-4b"])
def test_prefill_and_decode_step_match_jax(arch):
    """Two rows through two prefill chunks (the second with a padded
    tail and ``seq_lens``), then two decode steps, one of them with a
    row inactive in the port (``active``) against JAX's post-step select
    of the same step: logits within 1e-5 (MoE within 4e-6) at every real
    position, and the lengths equal. The fresh path (``fresh=True``)
    too, against JAX's."""
    jc, tc = _configs(arch)
    jparams = JT.init_params(jax.random.PRNGKey(3), jc, jnp.float32)
    params = TT.Transformer(tc, torch.device("cpu"), torch.float32)
    params.load_state_dict(_weights(jparams), strict=True)
    tol = 4e-6 if any(l.ffn == MOE for l in tc.layers) else 1e-5
    B, max_len = 2, 128
    jcache = JT.init_cache(jc, B, max_len, dtype=jnp.float32, chunk=max_len)
    tcache = TT.init_cache(tc, B, max_len, dtype=torch.float32,
                           chunk=max_len, device="cpu")
    rng = np.random.default_rng(4)

    def both(a):
        return jnp.asarray(a), torch.from_numpy(np.array(a))
    chunks = [(rng.integers(0, tc.vocab_size, (B, 24)).astype(np.int32),
               None),
              (rng.integers(0, tc.vocab_size, (B, 16)).astype(np.int32),
               np.array([16, 9], np.int32))]
    for i, (toks, lens) in enumerate(chunks):
        jt, tt = both(toks)
        js, ts = both(np.asarray(jcache["len"], np.int32))
        kw_j = {} if lens is None else dict(seq_lens=jnp.asarray(lens))
        kw_t = {} if lens is None else dict(seq_lens=torch.from_numpy(lens))
        jl, jcache = JT.prefill(jparams, jc, jcache, jt, js, serve=True,
                                fresh=i == 0, **kw_j)
        tl, tcache = TT.prefill(params, tc, tcache, tt, ts, fresh=i == 0,
                                **kw_t)
        real = 16 if lens is None else int(lens.min())
        np.testing.assert_allclose(tl[:, :real].numpy(),
                                   np.asarray(jl[:, :real]), rtol=0,
                                   atol=tol)
        if lens is not None:
            # the padded tail is bookkeeping: set the true lengths back
            real_len = np.asarray(jcache["len"]) - 16 + lens
            jcache["len"] = jnp.asarray(real_len, jnp.int32)
            tcache["len"][:] = torch.from_numpy(real_len.astype(np.int32))
    last = rng.integers(0, tc.vocab_size, (B, 1)).astype(np.int32)
    for active in (None, np.array([True, False])):
        jl, new = JT.decode_step(jparams, jc, jcache, jnp.asarray(last),
                                 serve=True)
        if active is not None:
            a = jnp.asarray(active)
            new = jax.tree.map(
                lambda n, o: jnp.where(
                    a.reshape((B,) + (1,) * (n.ndim - 1)), n, o),
                new, jcache)
        jcache = new
        tl, tcache = TT.decode_step(
            params, tc, tcache, torch.from_numpy(last),
            active=None if active is None else torch.from_numpy(active))
        # an inactive row's logits are discarded (JAX's read its reverted
        # write, the port's never wrote)
        rows = slice(None) if active is None else active
        np.testing.assert_allclose(tl.numpy()[rows], np.asarray(jl)[rows],
                                   rtol=0, atol=tol)
        np.testing.assert_array_equal(tcache["len"].numpy(),
                                      np.asarray(jcache["len"]))
        last = np.array(jnp.argmax(jl[:, :, :tc.vocab_size], -1),
                        np.int32)


# ---------------------------------------------------------------- engines

@pytest.mark.parametrize("arch", ALL_FAMILIES)
def test_reference_engine_streams_equal_jax(arch):
    jc, tc = _configs(arch)
    jeng = ReferenceJaxEngine(jc, n_slots=2, max_len=128, quantum=1, seed=7)
    want = drive_plans(jeng, JRequest, JQoS, JPlan)
    teng = ReferenceTorchEngine(tc, n_slots=2, max_len=128, quantum=1,
                                seed=7, params=_weights(jeng.params),
                                device="cpu")
    _drive_torch(teng)
    for rid, n in want.items():
        assert len(teng.generated[rid]) == n
    assert teng.generated == jeng.generated
    assert len(teng.iteration_log) == len(jeng.iteration_log) == 10


@pytest.mark.parametrize("arch", ["llama3.2-3b", "qwen3-moe-30b-a3b",
                                  "jamba-v0.1-52b", "gemma3-4b",
                                  "internvl2-76b"])
def test_dense_engine_streams_equal_jax_pallas(arch):
    jc, tc = _configs(arch)
    kw = dict(n_slots=2, max_len=128, quantum=16, seed=7)
    jeng = JaxEngine(jc, kv_layout="dense", attn_impl="pallas", **kw)
    drive_plans(jeng, JRequest, JQoS, JPlan)
    teng = TorchEngine(tc, kv_layout="dense", params=_weights(jeng.params),
                       device="cpu", **kw)
    assert teng.pool is None and teng.block_size == 128
    _drive_torch(teng)
    assert teng.generated == jeng.generated
    assert teng.buckets_seen == jeng.buckets_seen


@pytest.mark.parametrize("arch", FUSED_FAMILIES)
def test_fused_matches_reference_and_offline(arch):
    """Inside the port: the fused engine in both layouts, the reference
    engine and offline greedy decode stream the same tokens (offline
    greedy: not for internvl2-76b, whose stub zeroes the leading
    positions of every chunk, so a whole-prompt prefill is another
    input, as in JAX)."""
    _, cfg = _configs(arch)
    ref = ReferenceTorchEngine(cfg, n_slots=2, max_len=128, quantum=1,
                               seed=7, device="cpu")
    want = _drive_torch(ref)
    for layout in ("paged", "dense"):
        fus = TorchEngine(cfg, n_slots=2, max_len=128, quantum=16, seed=7,
                          kv_layout=layout, block_size=32, device="cpu")
        _drive_torch(fus)
        assert fus.generated == ref.generated, layout
    for rid, n in want.items():
        assert len(ref.generated[rid]) == n
        if cfg.frontend is None:
            assert ref.generated[rid] == offline_greedy(ref, cfg, rid, n)


def _two_iterations(params, cfg, cache, bts):
    """The final hidden states of two fused iterations from an empty
    cache: prefill rows for slots 0 and 1 (40 and 33 tokens in a
    64-token bucket), then slot 2's 21-token prefill beside slot 0's and
    1's decode (slot 2 inactive in the decode batch). ``bts``: the
    paged layout's block tables (slot s owns pages s*mb ..), or None."""
    rng = np.random.default_rng(1)
    prompts = [torch.as_tensor(rng.integers(0, cfg.vocab_size, n), **I32)
               for n in (40, 33, 21)]
    z = torch.zeros

    def bt(rows):
        return None if bts is None else bts[rows]
    pre = z((2, 64), **I32)
    pre[0, :40], pre[1, :33] = prompts[0], prompts[1]
    h1 = TT._sampled_hidden(
        params, cfg, cache, pre, torch.tensor([0, 1], **I32), z(2, **I32),
        torch.tensor([40, 33], **I32), torch.ones(2, dtype=torch.bool),
        torch.tensor([39, 32], **I32), z(0, **I32), z(0, **I32),
        z(0, dtype=torch.bool), bt(slice(0, 2)),
        None if bts is None else z((0, bts.shape[1]), **I32))
    w = params.lm_head if params.lm_head is not None else params.embed.T
    first = torch.argmax((h1 @ w)[:, :cfg.vocab_size], -1).to(torch.int32)
    pre2 = z((1, 32), **I32)
    pre2[0, :21] = prompts[2]
    h2 = TT._sampled_hidden(
        params, cfg, cache, pre2, torch.tensor([2], **I32), z(1, **I32),
        torch.tensor([21], **I32), torch.ones(1, dtype=torch.bool),
        torch.tensor([20], **I32),
        torch.tensor([first[0], first[1], 0], **I32),
        torch.tensor([40, 33, 0], **I32), torch.tensor([True, True, False]),
        bt(slice(2, 3)), bt(slice(0, 3)))
    return prompts, first, h1, h2, w


@pytest.mark.parametrize("arch", FUSED_FAMILIES)
def test_fused_hidden_states_paged_dense_and_reference(arch):
    """The fused iterations of ``_two_iterations`` in the paged and the
    dense layout give bit-equal final hidden states; the reference
    engine's path (``prefill`` per slot with the stubs' extras, then
    ``decode_step`` with slot 2 inactive) gives bit-equal logits, except
    for the Mamba2 family: within 1e-6 (the fused row is padded to its
    bucket, the reference's is exact-length, and the plain SSD scan sums
    them in another order; measured 2.4e-7)."""
    _, cfg = _configs(arch)
    params = TT.init_params(cfg, torch.Generator().manual_seed(3), "cpu",
                            torch.float32)
    n, R, bs = 3, 128, 32
    mb = R // bs
    paged = TT.init_paged_cache(cfg, n, n * mb, bs, torch.float32, "cpu")
    dense = TT.init_cache(cfg, n, R, torch.float32, chunk=R, device="cpu")
    dense.pop("len")
    bts = torch.arange(n * mb, **I32).view(n, mb)
    _, _, hp1, hp2, _ = _two_iterations(params, cfg, paged, bts)
    prompts, first, hd1, hd2, w = _two_iterations(params, cfg, dense, None)
    assert torch.equal(hp1, hd1) and torch.equal(hp2, hd2)
    eng = ReferenceTorchEngine(cfg, n_slots=n, max_len=R, quantum=1,
                               device="cpu")
    eng.params = params
    logits = []
    for s in range(3):
        logits.append(eng._prefill_slot(prompts[s].numpy(), s, 0,
                                        len(prompts[s]),
                                        eng._extras(1))[0, -1])
    eng._last_token[:2] = first.numpy()
    dec = eng._decode_all(np.array([True, True, False]))
    ref = torch.stack(logits[:2] + [logits[2], dec[0], dec[1]])
    fused = torch.cat([hd1 @ w, hd2[:3] @ w])
    if any(l.mixer == "mamba" for l in cfg.layers):
        np.testing.assert_allclose(fused.numpy(), ref.numpy(), rtol=0,
                                   atol=1e-6)
    else:
        assert torch.equal(fused, ref)


def test_dense_decode_reads_256_token_pages_as_a_view(monkeypatch):
    """The dense layout's decode rows go to ``paged_attention`` over
    pages of min(R, 256) tokens that are views of the slots' rows (no
    copy: the sink row follows them), with an iota block table; a
    windowed layer's decode rows, and every row when R is not a multiple
    of 256, go to ``chunked_prefill_attention``."""
    seen = []
    real = ops.paged_attention

    def spy(q, k_pages, v_pages, bt, lens, **kw):
        seen.append((k_pages, bt.clone()))
        return real(q, k_pages, v_pages, bt, lens, **kw)
    monkeypatch.setattr(ops, "paged_attention", spy)
    for max_len, pages in ((512, 2), (128, 1), (384, 0)):
        _, cfg = _configs("llama3.2-3b")
        eng = TorchEngine(cfg, n_slots=3, max_len=max_len, quantum=16,
                          kv_layout="dense", device="cpu")
        seen.clear()
        ops.reset_counts()
        eng.warm()
        counts = ops.counts()
        assert counts["paged_attention"]["plain"] == (
            cfg.num_layers if pages else 0)
        storages = {c.k.untyped_storage().data_ptr()
                    for c in eng.cache["layers"]}
        for k_pages, bt in seen:
            assert k_pages.shape[1] == min(max_len, 256)
            assert k_pages.untyped_storage().data_ptr() in storages
            assert torch.equal(bt.flatten(),
                               torch.arange(3 * pages, **I32))
    ops.reset_counts()


def test_dense_warm_writes_no_live_rows():
    _, cfg = _configs("jamba-v0.1-52b")
    eng = TorchEngine(cfg, n_slots=2, max_len=64, quantum=16,
                      kv_layout="dense", device="cpu")
    for c in eng.cache["layers"]:
        for t in c:
            if t.dtype.is_floating_point:
                t.normal_()
    before = [[t[:-1].clone() for t in c] for c in eng.cache["layers"]]
    eng.warm()
    for b, c in zip(before, eng.cache["layers"]):
        for x, t in zip(b, c):
            assert torch.equal(x, t[:-1])


def test_dense_layout_refuses_int8_pages():
    _, cfg = _configs("llama3.2-3b")
    with pytest.raises(ValueError, match="paged layout"):
        TorchEngine(cfg, kv_layout="dense", kv_quant=True, device="cpu")
    with pytest.raises(KeyError):
        make_engine("no-such-engine", cfg)


# ---------------------------------------------------------------- twins

def test_reference_decode_does_not_corrupt_completing_prefill():
    """Twin of tests/test_fused_engine.py:251: a prefill completing in
    the same iteration as a live decode batch must not have its fresh
    token duplicated or its length bumped by the batched decode."""
    _, cfg = _configs("llama3.2-3b")
    eng = ReferenceTorchEngine(cfg, n_slots=2, max_len=128, quantum=1,
                               seed=3, device="cpu")
    qos = QoSSpec("q", interactive=True, ttft_slo=1e6, tbt_slo=1e6)
    ra = Request(rid=0, arrival=0.0, prompt_len=30, decode_len=4, qos=qos)
    rb = Request(rid=1, arrival=0.0, prompt_len=20, decode_len=3, qos=qos)
    eng.on_admit(ra)
    eng.on_admit(rb)
    eng.execute(BatchPlan(prefill=[(ra, 30)]), 0.0)
    ra.prefilled = 30
    eng.execute(BatchPlan(prefill=[(rb, 20)], decode=[ra]), 0.0)
    rb.prefilled = 20
    for _ in range(2):
        eng.execute(BatchPlan(decode=[ra, rb]), 0.0)
    eng.execute(BatchPlan(decode=[ra]), 0.0)
    for rid in (0, 1):
        got = eng.generated[rid]
        assert got == offline_greedy(eng, cfg, rid, len(got)), rid


def test_reference_quantum_padding_preserves_mamba_state():
    """Twin of tests/test_fused_engine.py:277: a bucket-padded prefill
    chunk (quantum 16, 17 tokens padded to 32) neither shows its pad
    tokens to attention (the length is set back) nor advances Mamba
    state (``seq_lens``)."""
    _, cfg = _configs("jamba-v0.1-52b")
    eng = ReferenceTorchEngine(cfg, n_slots=1, max_len=128, quantum=16,
                               seed=2, device="cpu")
    qos = QoSSpec("q", interactive=True, ttft_slo=1e6, tbt_slo=1e6)
    r = Request(rid=0, arrival=0.0, prompt_len=17, decode_len=3, qos=qos)
    eng.on_admit(r)
    eng.execute(BatchPlan(prefill=[(r, 17)]), 0.0)   # padded to 32
    assert int(eng.cache["len"][0]) == 17
    r.prefilled = 17
    eng.execute(BatchPlan(decode=[r]), 0.0)
    eng.execute(BatchPlan(decode=[r]), 0.0)
    assert eng.generated[0] == offline_greedy(eng, cfg, 0, 3)


def test_reference_extras_cached_per_batch_size():
    """Twin of tests/test_fused_engine.py:422, on the engine's device."""
    _, cfg = _configs("internvl2-76b")
    eng = ReferenceTorchEngine(cfg, n_slots=1, max_len=64, seed=0,
                               device="cpu")
    a = eng._extras(1)
    assert eng._extras(1) is a            # no per-call re-allocation
    assert set(a) == {"frontend_embeds"}
    assert a["frontend_embeds"].shape == (1, 8, 128)
    assert a["frontend_embeds"].device == eng.device
    assert eng._extras(2) is not a


class _FixedClock:
    """A constant iteration time, so that replicas over different
    engines make the same scheduling decisions."""

    def __init__(self, inner):
        self.inner = inner

    def execute(self, plan, now):
        self.inner.execute(plan, now)
        return 0.05

    def __getattr__(self, name):
        return getattr(self.inner, name)


def test_scheduler_integration_streams_equal():
    """Twin of tests/test_fused_engine.py:325: the scheduler and replica
    stack over the reference engine and the fused engine in both
    layouts, under the same virtual clock, streams the same tokens for 4
    requests through 2 slots, and they equal offline greedy."""
    _, cfg = _configs("llama3.2-3b")
    qos = QoSSpec("q", interactive=True, ttft_slo=1e6, tbt_slo=1e6)

    def run(engine):
        sched = NiyamaScheduler(ModelCostModel(cfg, CPU_HW),
                                cfg=NiyamaConfig(max_chunk=128, quantum=16,
                                                 max_decode_batch=2))
        rep = Replica(scheduler=sched, backend=_FixedClock(engine),
                      kv=KVPool(num_blocks=2, block_size=128))
        rep.submit_all([Request(rid=i, arrival=0.4 * i,
                                prompt_len=18 + 7 * i,
                                decode_len=3 + (i % 3), qos=qos, app_id="a")
                        for i in range(4)])
        rep.run()
        assert len(rep.finished) == 4
        return engine.generated
    ref = ReferenceTorchEngine(cfg, n_slots=2, max_len=128, quantum=1,
                               seed=5, device="cpu")
    want = run(ref)
    for layout in ("paged", "dense"):
        assert run(TorchEngine(cfg, n_slots=2, max_len=128, quantum=16,
                               seed=5, kv_layout=layout, block_size=32,
                               device="cpu")) == want, layout
    for rid, toks in want.items():
        assert toks == offline_greedy(ref, cfg, rid, len(toks))


def test_replica_factory_sizes_and_refuses_as_jax():
    _, cfg = _configs("llama3.2-3b")
    kw = dict(n_slots=2, max_len=128, device="cpu")
    dense = make_torch_replica("niyama", cfg, kv_layout="dense", **kw)
    assert (dense.kv.num_blocks, dense.kv.block_size) == (2, 128)
    assert not dense.backend.paged and dense.backend.pool is None
    ref = make_torch_replica("niyama", cfg, engine="reference", **kw)
    assert isinstance(ref.backend, ReferenceTorchEngine)
    assert ref.backend.quantum == 1
    with pytest.raises(ValueError, match="paged"):
        make_torch_replica("niyama", cfg, kv_layout="dense",
                           kv_cfg=KVCacheConfig(enable_prefix=True), **kw)
    with pytest.raises(ValueError, match="fused"):
        make_torch_replica("niyama", cfg, engine="reference",
                           kv_cfg=KVCacheConfig(enable_prefix=True), **kw)


def test_serve_rejects_dense_hierarchy():
    """Twin of tests/test_serve_e2e.py:37."""
    with pytest.raises(ValueError, match="paged"):
        serve.main(["--device", "cpu", "--reduced", "--kv-layout", "dense",
                    "--prefix-cache", "--n-requests", "1"])


@pytest.mark.parametrize("flags", [["--engine", "reference"],
                                   ["--kv-layout", "dense"]])
def test_serve_reference_and_dense_end_to_end(flags):
    rep = serve.main(["--device", "cpu", "--reduced", "--n-requests", "3",
                      "--slots", "2", "--max-len", "128", "--seed", "1",
                      *flags])
    assert len(rep.finished) == 3
    for r in rep.finished:
        assert len(rep.backend.generated[r.rid]) == r.decode_len
