"""int8 KV pages in the port against the JAX package: ``_quantize``, the
quantized page write and the bf16 dequantized view bit for bit, the plain
int8 decode against the JAX int8 Pallas kernel (interpret mode), and
``TorchEngine(kv_quant=True)`` against ``JaxEngine(kv_quant=True,
attn_impl="pallas")`` on the same weights and plans.

Tolerances: the quantization, the write and the view are the same
arithmetic on both sides, so they are held bit for bit. The int8 decode
dequantizes exactly in fp32 on both sides and differs only in summation
order: 2e-5 with an f32 query (tests/test_kernels.py's f32 tolerance).
Across the engines, hidden states differ by about 1e-6 between the
frameworks, so a k value on a rounding boundary may land one int8 step
apart: the token streams must be equal, the pages within one int8 step
and the scales within one bf16 ulp.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core.qos import QoSSpec as JQoS  # noqa: E402
from repro.core.request import Request as JRequest  # noqa: E402
from repro.core.scheduler import BatchPlan as JPlan  # noqa: E402
from repro.engine.jax_backend import JaxEngine  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.qos import QoSSpec as TQoS  # noqa: E402
from repro_torch.core.request import Request as TRequest  # noqa: E402
from repro_torch.core.scheduler import BatchPlan as TPlan  # noqa: E402
from repro_torch.engine.torch_backend import TorchEngine  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402


def _bits(a) -> np.ndarray:
    """The raw bits of a bf16 array, JAX's or the port's."""
    if isinstance(a, torch.Tensor):
        return a.view(torch.int16).numpy()
    return np.asarray(a).view(np.int16)


def _quant_input(rng, shape, dt):
    """Values spread over four decades per (token, head), an all-zero
    head (the scale's 1e-8 floor) and a head whose max lands on +-127."""
    x = rng.standard_normal(shape).astype(np.float32) \
        * 10.0 ** rng.uniform(-2, 2, shape[:-1] + (1,)).astype(np.float32)
    x[0, 0, 0] = 0.0
    x[0, 1, 1] = np.linspace(-3.0, 3.0, shape[-1], dtype=np.float32)
    if dt == "bf16":
        x = np.asarray(jnp.asarray(x).astype(jnp.bfloat16), np.float32)
    return x


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_quantize_bit_equal_to_jax(dt):
    rng = np.random.default_rng(0)
    x = _quant_input(rng, (3, 17, 4, 64), dt)
    jd, td = (jnp.float32, torch.float32) if dt == "f32" \
        else (jnp.bfloat16, torch.bfloat16)
    jq, js = JT._quantize(jnp.asarray(x).astype(jd))
    tq, ts = TT._quantize(torch.from_numpy(x).to(td))
    assert tq.dtype == torch.int8 and ts.dtype == torch.bfloat16
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(_bits(ts), _bits(js))
    assert (tq[0, 0, 0] == 0).all()
    assert float(ts[0, 0, 0]) == float(np.float32(1e-8).astype(
        jnp.bfloat16))
    assert int(tq[0, 1, 1].max()) == 127 and int(tq[0, 1, 1].min()) == -127


def test_quantize_rounds_half_to_even_as_jax():
    """Values at k + 1/2 of the scale round to the even neighbour on
    both sides (the scale is exactly 1 here: max 127)."""
    x = np.zeros((1, 1, 1, 512), np.float32)
    x[..., :509] = np.arange(-254, 255, dtype=np.float32) / 2.0
    x[..., 509] = 127.0
    jq, _ = JT._quantize(jnp.asarray(x))
    tq, _ = TT._quantize(torch.from_numpy(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert int(tq[0, 0, 0, 255]) == 0 and int(tq[0, 0, 0, 257]) == 2


def _quant_pages(rng, P, page, KV, D):
    """int8 pages and bf16 scales as ``_quantize`` makes them, from the
    port (bit-equal to JAX's, above), as numpy: (k8, v8, ks, vs), the
    scales as float32 (exact)."""
    kp = torch.from_numpy(rng.standard_normal((P, page, KV, D),
                                              np.float32) * 2.0)
    vp = torch.from_numpy(rng.standard_normal((P, page, KV, D),
                                              np.float32))
    k8, ks = TT._quantize(kp)
    v8, vs = TT._quantize(vp)
    return k8.numpy(), v8.numpy(), ks.float().numpy(), vs.float().numpy()


@pytest.mark.parametrize("B,H,KV,D,P,page,pages,lens,holes", [
    (2, 8, 4, 64, 16, 64, 4, (190, 100), ()),
    (3, 4, 4, 64, 12, 32, 4, (128, 1, 97), ()),
    # G = 3, a -1 hole mid-table, lens off the page grid, and a row
    # whose table is all -1 (an inactive decode slot)
    (3, 6, 2, 32, 20, 16, 6, (83, 40, 57), ((0, 2), (2, 0), (2, 1),
                                            (2, 2), (2, 3))),
])
def test_plain_int8_decode_vs_jax_pallas(B, H, KV, D, P, page, pages, lens,
                                         holes):
    rng = np.random.default_rng(4)
    k8, v8, ks, vs = _quant_pages(rng, P, page, KV, D)
    q = rng.standard_normal((B, H, D), np.float32)
    bt = np.full((B, pages), -1, np.int32)
    for b in range(B):
        bt[b, :-(-lens[b] // page)] = rng.choice(P, -(-lens[b] // page),
                                                 replace=False)
    for b, pi in holes:
        bt[b, pi] = -1
    ln = np.asarray(lens, np.int32)
    tks, tvs = (torch.from_numpy(s).to(torch.bfloat16) for s in (ks, vs))
    got = tops.paged_attention(
        torch.from_numpy(q), torch.from_numpy(k8), torch.from_numpy(v8),
        torch.from_numpy(bt), torch.from_numpy(ln), k_scales=tks,
        v_scales=tvs)
    want = jops.paged_attention(
        jnp.asarray(q), jnp.asarray(k8), jnp.asarray(v8), jnp.asarray(bt),
        jnp.asarray(ln), k_scales=jnp.asarray(ks).astype(jnp.bfloat16),
        v_scales=jnp.asarray(vs).astype(jnp.bfloat16), interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)
    for b in range(B):
        if (bt[b] < 0).all():
            assert (got[b] == 0).all()


def test_init_paged_cache_int8_layout():
    cfg = get_config("llama3.2-3b").reduced(num_layers=2, d_model=128)
    cache = TT.init_paged_cache(cfg, 2, 6, 16, device="cpu", kv_quant=True)
    for c in cache["layers"]:
        assert isinstance(c, TT.QuantPagedAttnCache)
        shape = (7, 16, cfg.num_kv_heads, cfg.head_dim)
        assert c.k.shape == c.v.shape == shape
        assert c.k.dtype == c.v.dtype == torch.int8
        assert c.k_scale.shape == c.v_scale.shape == shape[:3]
        assert c.k_scale.dtype == c.v_scale.dtype == torch.bfloat16


def test_bridge_carries_int8_caches_both_ways():
    """A JAX int8 paged cache crosses into the port with its int8 pages
    and bf16 scales bit for bit (the bf16 arrays through an int16 view)
    and comes back with the pages int8 and the scales as exact f32."""
    jc = jax_get_config("llama3.2-3b").reduced(num_layers=2, d_model=128)
    rng = np.random.default_rng(8)
    cache = JT.init_paged_cache(jc, 2, 6, 16, kv_quant=True)
    layers = []
    for c in cache["layers"]:
        k8, ks = JT._quantize(jnp.asarray(rng.standard_normal(
            c.k.shape[:3] + (c.k.shape[3],)).astype(np.float32)))
        layers.append(JT.QuantPagedAttnCache(k8, -k8, ks, ks * 2))
    host = {"layers": [type(c)(*(np.asarray(a) for a in c))
                       for c in layers]}
    tc = bridge.paged_cache_from_numpy(host, device="cpu")
    for j, t in zip(layers, tc["layers"]):
        assert isinstance(t, TT.QuantPagedAttnCache)
        assert t.k.dtype == torch.int8 and t.k_scale.dtype == torch.bfloat16
        assert t.k.shape[0] == j.k.shape[0] + 1        # the sink page
        np.testing.assert_array_equal(t.k[:-1].numpy(), np.asarray(j.k))
        np.testing.assert_array_equal(t.v[:-1].numpy(), np.asarray(j.v))
        np.testing.assert_array_equal(_bits(t.k_scale[:-1]),
                                      _bits(j.k_scale))
        np.testing.assert_array_equal(_bits(t.v_scale[:-1]),
                                      _bits(j.v_scale))
    back = bridge.paged_cache_to_numpy(tc)["layers"]
    for j, b in zip(layers, back):
        assert b[0].dtype == np.int8 and b[2].dtype == np.float32
        np.testing.assert_array_equal(b[0], np.asarray(j.k))
        np.testing.assert_array_equal(
            b[3], np.asarray(j.v_scale.astype(jnp.float32)))


def test_quant_write_and_view_bit_equal_to_jax():
    """``_paged_write`` into int8 pages (with invalid writes to the sink
    in the port and dropped in JAX) and the bf16 dequantized
    ``_paged_view`` of a bucketed table hold the same bits as JAX's."""
    rng = np.random.default_rng(5)
    nb, bs, KV, hd, B, S = 10, 8, 2, 32, 3, 12
    k_new = rng.standard_normal((B, S, KV, hd)).astype(np.float32)
    v_new = rng.standard_normal((B, S, KV, hd)).astype(np.float32) * 3.0
    start = np.array([0, 5, 20], np.int32)
    bt = np.array([[3, 7, -1], [0, 9, -1], [1, 2, 4]], np.int32)
    valid = np.ones((B, S), bool)
    valid[1, 9:] = False
    jc = JT.QuantPagedAttnCache(
        k=jnp.zeros((nb, bs, KV, hd), jnp.int8),
        v=jnp.zeros((nb, bs, KV, hd), jnp.int8),
        k_scale=jnp.zeros((nb, bs, KV), jnp.bfloat16),
        v_scale=jnp.zeros((nb, bs, KV), jnp.bfloat16))
    jc = JT._paged_write(jc, jnp.asarray(k_new), jnp.asarray(v_new),
                         jnp.asarray(start), jnp.asarray(bt),
                         jnp.asarray(valid))
    tc = TT.QuantPagedAttnCache(
        torch.zeros((nb + 1, bs, KV, hd), dtype=torch.int8),
        torch.zeros((nb + 1, bs, KV, hd), dtype=torch.int8),
        torch.zeros((nb + 1, bs, KV), dtype=torch.bfloat16),
        torch.zeros((nb + 1, bs, KV), dtype=torch.bfloat16))
    TT._paged_write(tc, torch.from_numpy(k_new), torch.from_numpy(v_new),
                    torch.from_numpy(start), torch.from_numpy(bt),
                    torch.from_numpy(valid))
    np.testing.assert_array_equal(tc.k[:-1].numpy(), np.asarray(jc.k))
    np.testing.assert_array_equal(tc.v[:-1].numpy(), np.asarray(jc.v))
    np.testing.assert_array_equal(_bits(tc.k_scale[:-1]),
                                  _bits(jc.k_scale))
    np.testing.assert_array_equal(_bits(tc.v_scale[:-1]),
                                  _bits(jc.v_scale))
    for width in (2, 3):
        jk, jv = JT._paged_view(jc, jnp.asarray(bt[:, :width]))
        tk, tv = TT._paged_view(tc, torch.from_numpy(bt[:, :width]))
        assert tk.dtype == torch.bfloat16
        np.testing.assert_array_equal(_bits(tk), _bits(jk))
        np.testing.assert_array_equal(_bits(tv), _bits(jv))


def _drive(engine, req_cls, qos_cls, plan_cls):
    """The plan of tests/test_paged_quant.py::drive: a two-chunk prefill,
    a prompt completing beside a live decode, joint and single decodes."""
    qos = qos_cls("q", interactive=True, ttft_slo=1e6, tbt_slo=1e6)
    r0 = req_cls(rid=0, arrival=0.0, prompt_len=40, decode_len=5, qos=qos)
    r1 = req_cls(rid=1, arrival=0.0, prompt_len=33, decode_len=4, qos=qos)
    engine.on_admit(r0)
    engine.on_admit(r1)
    engine.execute(plan_cls(prefill=[(r0, 24)]), 0.0)
    r0.prefilled = 24
    engine.execute(plan_cls(prefill=[(r0, 16)]), 0.0)
    r0.prefilled = 40
    engine.execute(plan_cls(prefill=[(r1, 33)], decode=[r0]), 0.0)
    r1.prefilled = 33
    for _ in range(3):
        engine.execute(plan_cls(decode=[r0, r1]), 0.0)
    engine.execute(plan_cls(decode=[r1]), 0.0)
    engine.on_release(r0)
    engine.on_release(r1)


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    """One bf16 ulp at |x| (8 significant bits)."""
    e = np.floor(np.log2(np.maximum(np.abs(x), 1e-30)))
    return np.exp2(e - 7)


@pytest.mark.parametrize("arch", ["llama3.2-3b"])
def test_int8_engine_streams_equal_jax_int8_engine(arch):
    jc = jax_get_config(arch).reduced(num_layers=2, d_model=128)
    tc = get_config(arch).reduced(num_layers=2, d_model=128)
    kw = dict(n_slots=2, max_len=128, quantum=16, seed=7, block_size=32)
    jeng = JaxEngine(jc, attn_impl="pallas", kv_layout="paged",
                     kv_quant=True, **kw)
    sd = bridge.params_from_numpy(jax.tree.map(np.asarray, jeng.params))
    teng = TorchEngine(tc, params=sd, device="cpu", kv_quant=True, **kw)
    assert isinstance(teng.cache["layers"][0], TT.QuantPagedAttnCache)
    tops.reset_counts()
    _drive(jeng, JRequest, JQoS, JPlan)
    _drive(teng, TRequest, TQoS, TPlan)
    counts = tops.counts()
    # the decode batch went through the int8 plain version, never the
    # model-dtype one; nothing launched on the CPU
    assert counts["paged_attention_int8"]["plain"] > 0
    assert counts["paged_attention"]["plain"] == 0
    assert all(c["launches"] == 0 for c in counts.values())
    tops.reset_counts()
    assert teng.generated == jeng.generated
    assert [len(teng.generated[r]) for r in (0, 1)] == [5, 5]
    # the pages after the run: int8 within one step, scales within one
    # bf16 ulp
    jpages = [(np.asarray(c.k), np.asarray(c.v),
               np.asarray(c.k_scale.astype(jnp.float32)),
               np.asarray(c.v_scale.astype(jnp.float32)))
              for c in jeng.cache["layers"]]
    tpages = bridge.paged_cache_to_numpy(teng.cache)["layers"]
    differ, total = 0, 0
    for jl, tl in zip(jpages, tpages):
        for f in (0, 1):
            assert tl[f].dtype == np.int8
            d = np.abs(tl[f].astype(np.int32) - jl[f].astype(np.int32))
            assert d.max() <= 1
            differ += int((d > 0).sum())
            total += d.size
        for f in (2, 3):
            d = np.abs(tl[f] - jl[f])
            assert (d <= _bf16_ulp(np.maximum(np.abs(tl[f]),
                                              np.abs(jl[f])))).all()
    print(f"int8 page values one step apart: {differ} of {total} "
          f"({differ / total:.2e})")


def test_cpu_int8_tensors_never_reach_the_kernel_wrapper():
    from repro_torch.kernels import paged_attention_int8 as pa8
    rng = np.random.default_rng(6)
    k8, v8, ks, vs = (torch.from_numpy(a)
                      for a in _quant_pages(rng, 6, 16, 2, 64))
    ks, vs = ks.to(torch.bfloat16), vs.to(torch.bfloat16)
    q = torch.from_numpy(rng.standard_normal((2, 4, 64), np.float32))
    bt = torch.tensor([[0, 3], [5, -1]], dtype=torch.int32)
    ln = torch.tensor([20, 9], dtype=torch.int32)
    tops.reset_counts()
    out = tops.paged_attention(q, k8, v8, bt, ln, k_scales=ks, v_scales=vs)
    assert out.dtype == torch.float32 and out.shape == (2, 4, 64)
    assert tops.counts()["paged_attention_int8"] == {"launches": 0,
                                                     "plain": 1}
    assert tops.counts()["paged_attention"] == {"launches": 0, "plain": 0}
    assert pa8.launches == 0
    with pytest.raises(ValueError, match="CUDA"):
        pa8.paged_attention_int8_cuda(q, k8, v8, ks, vs, bt, ln)
    tops.reset_counts()
