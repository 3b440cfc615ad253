"""The port's serve-path model against the JAX package's, on the same
numpy inputs and the JAX weights carried across by ``repro_torch.bridge``.

Two small configurations: ``reduced("llama3.2-3b")`` (H = KV, G = 1) and
a narrow one with the full model's 24:8 head ratio (H=6, KV=2, G=3), so
that GQA grouping runs end to end. JAX is compared in both of its
attention paths, ``"jnp"`` and ``"pallas"`` (interpret mode).

Tolerances (f32): 1e-6 for the element-wise layers, exact for the page
writes (they copy values), 1e-5 for hidden states and written pages
after two layers (summation order of XLA against ATen).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402

NARROW = dict(num_heads=6, num_kv_heads=2, head_dim=32)


def configs(name):
    """(JAX config, port config): the same fields in both packages."""
    jc = jax_get_config("llama3.2-3b").reduced(num_layers=2, d_model=128)
    tc = get_config("llama3.2-3b").reduced(num_layers=2, d_model=128)
    if name == "narrow":
        jc = dataclasses.replace(jc, **NARROW)
        tc = dataclasses.replace(tc, **NARROW)
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    return jc, tc


def test_layers_elementwise():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 3, 32), np.float32)
    w = rng.standard_normal((32,), np.float32) * 0.1
    pos1 = np.arange(7, 12, dtype=np.int32)
    pos2 = rng.integers(0, 4000, (2, 5)).astype(np.int32)
    t = torch.from_numpy
    np.testing.assert_allclose(
        TL.rmsnorm(t(x), t(w)).numpy(),
        np.asarray(JL.rmsnorm(jnp.asarray(x), jnp.asarray(w))),
        rtol=1e-6, atol=1e-6)
    for pos in (pos1, pos2):
        np.testing.assert_allclose(
            TL.apply_rope(t(x), t(pos), 500_000.0).numpy(),
            np.asarray(JL.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                                     500_000.0)),
            rtol=1e-5, atol=1e-5)
    h = rng.standard_normal((4, 16), np.float32)
    wg, wu = (rng.standard_normal((16, 24), np.float32) * 0.25
              for _ in range(2))
    wd = rng.standard_normal((24, 16), np.float32) * 0.2
    np.testing.assert_allclose(
        TL.swiglu(t(h), t(wg), t(wu), t(wd)).numpy(),
        np.asarray(JL.swiglu(*(jnp.asarray(a) for a in (h, wg, wu, wd)))),
        rtol=1e-5, atol=1e-6)


def test_paged_write_matches_jax_and_spares_live_pages():
    """Pad rows, pad columns, -1 table entries and writes past the table
    land where JAX drops them (the port's sink page); every live page
    ends up exactly as JAX writes it, and pages that only a pad row's
    table names are untouched."""
    rng = np.random.default_rng(1)
    nb, bs, KV, hd, B, S = 10, 8, 2, 4, 4, 12
    k0 = rng.standard_normal((nb, bs, KV, hd), np.float32)
    v0 = rng.standard_normal((nb, bs, KV, hd), np.float32)
    kn = rng.standard_normal((B, S, KV, hd), np.float32)
    vn = rng.standard_normal((B, S, KV, hd), np.float32)
    start = np.array([0, 5, 20, 3], np.int32)
    bt = np.array([[1, 2, -1],      # tail past block 1 hits a -1 entry
                   [3, 4, 0],
                   [-1, -1, 5],     # block 3 is past the table width
                   [6, 7, 8]],      # pad row: its pages must not change
                  np.int32)
    valid = np.ones((B, S), bool)
    valid[1, 9:] = False            # pad columns
    valid[3] = False                # pad row
    jc = JT._paged_write(JT.PagedAttnCache(jnp.asarray(k0), jnp.asarray(v0)),
                         jnp.asarray(kn), jnp.asarray(vn), jnp.asarray(start),
                         jnp.asarray(bt), jnp.asarray(valid))
    tc = bridge.paged_cache_from_numpy({"layers": [(k0, v0)]},
                                       device="cpu")["layers"][0]
    TT._paged_write(tc, torch.from_numpy(kn), torch.from_numpy(vn),
                    torch.from_numpy(start), torch.from_numpy(bt),
                    torch.from_numpy(valid))
    np.testing.assert_array_equal(tc.k[:nb].numpy(), np.asarray(jc.k))
    np.testing.assert_array_equal(tc.v[:nb].numpy(), np.asarray(jc.v))
    np.testing.assert_array_equal(tc.k[6:9].numpy(), k0[6:9])
    np.testing.assert_array_equal(tc.k[9].numpy(), k0[9])
    assert not np.array_equal(tc.k[1].numpy(), k0[1])   # live writes landed


def test_init_params_shapes_match_bridged_jax_tree():
    jc, tc = configs("narrow")
    jp = jax.tree.map(np.asarray, JT.init_params(jax.random.PRNGKey(0), jc))
    sd = bridge.params_from_numpy(jp)
    gen = torch.Generator().manual_seed(0)
    model = TT.init_params(tc, gen, "cpu", torch.float32)
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == \
        {k: tuple(v.shape) for k, v in sd.items()}
    assert "layers.1.attn.wq" in sd and sd["layers.1.attn.wq"].shape == \
        (128, 6, 32)
    wq = model.layers[0].attn.wq
    assert abs(float(wq.std()) - 128 ** -0.5) < 0.01
    assert float(model.final_norm.abs().max()) == 0.0
    model.load_state_dict(sd, strict=True)
    np.testing.assert_array_equal(model.layers[1].ffn.w_down.numpy(),
                                  jp["layers"][1]["ffn"]["w_down"])


def _mixed_plan(cfg, rng):
    """Two prefill rows (one at a 16-token prefix) and two pad rows; a
    decode batch of 4 slots, two active and two inactive, one of which
    (slot 1) holds a positive length mid-prefill. The arrays in the order
    of ``fused_serve_forward``'s arguments; pad rows carry slot
    ``n_slots``."""
    n_slots, maxb = 4, 4
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
    live = np.r_[pre_len > 0, dec_active]
    return (pre_tokens, pre_slots, pre_start, pre_len, pre_reset,
            pre_sample, dec_tokens, dec_start, dec_active, pre_bt,
            dec_bt), live


def _jax_hidden(params, cfg, cache, pre_tokens, pre_slots, pre_start,
                pre_len, pre_reset, pre_sample, dec_tokens, dec_start,
                dec_active, pre_bt, dec_bt, attn_impl):
    """The layers and final norm of JAX's fused_serve_forward, stopped
    before its LM head (the rows the head reads)."""
    P, L = pre_tokens.shape
    x_pre = JT._embed(params, cfg, pre_tokens, None)
    x_dec = JT._embed(params, cfg, dec_tokens[:, None], None)
    pre_valid = jnp.arange(L)[None, :] < pre_len[:, None]
    layers = []
    for li, spec in enumerate(cfg.layers):
        x_pre, x_dec, nc = JT._fused_block(
            params["layers"][li], cfg, spec, x_pre, x_dec,
            cache["layers"][li], pre_slots, pre_start, pre_len, pre_reset,
            pre_valid, dec_start, dec_active, JT._identity_shard, attn_impl,
            pre_bt=pre_bt, dec_bt=dec_bt)
        layers.append(nc)
    x_pre = JL.rmsnorm(x_pre, params["final_norm"], cfg.norm_eps)
    x_dec = JL.rmsnorm(x_dec, params["final_norm"], cfg.norm_eps)
    xs = jnp.concatenate([x_pre[jnp.arange(P), pre_sample], x_dec[:, 0]])
    return xs, {"layers": layers}


@pytest.mark.parametrize("attn_impl", ["jnp", "pallas"])
@pytest.mark.parametrize("cfg_name", ["reduced", "narrow"])
def test_fused_serve_forward_matches_jax(cfg_name, attn_impl):
    jc, tc = configs(cfg_name)
    rng = np.random.default_rng(2)
    jp = JT.init_params(jax.random.PRNGKey(3), jc)
    sd = bridge.params_from_numpy(jax.tree.map(np.asarray, jp))
    model = TT.Transformer(tc, "cpu", torch.float32)
    model.load_state_dict(sd, strict=True)
    nb, bs = 16, 16
    pages = [tuple(rng.standard_normal((nb, bs, tc.num_kv_heads,
                                        tc.head_dim), np.float32)
                   for _ in range(2)) for _ in tc.layers]
    arrs, live = _mixed_plan(tc, rng)
    jarrs = [jnp.asarray(a) for a in arrs]
    jcache = {"layers": [JT.PagedAttnCache(jnp.asarray(k), jnp.asarray(v))
                         for k, v in pages]}
    want_ids, _ = JT.fused_serve_forward(
        jp, jc, jcache, *jarrs[:9], pre_bt=jarrs[9], dec_bt=jarrs[10],
        attn_impl=attn_impl)
    want_hid, want_cache = _jax_hidden(jp, jc, jcache, *jarrs,
                                       attn_impl=attn_impl)

    tarrs = [torch.from_numpy(a) for a in arrs]
    cache = bridge.paged_cache_from_numpy({"layers": pages}, device="cpu")
    with torch.inference_mode():
        hid = TT._sampled_hidden(model, tc, cache, *tarrs)
    cache = bridge.paged_cache_from_numpy({"layers": pages}, device="cpu")
    ids = TT.fused_serve_forward(model, tc, cache, *tarrs)

    np.testing.assert_array_equal(ids.numpy()[live],
                                  np.asarray(want_ids)[live])
    np.testing.assert_allclose(hid.numpy()[live],
                               np.asarray(want_hid)[live],
                               rtol=1e-5, atol=1e-5)
    got_pages = bridge.paged_cache_to_numpy(cache)["layers"]
    for (gk, gv), jcl in zip(got_pages, want_cache["layers"]):
        np.testing.assert_allclose(gk, np.asarray(jcl.k), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(gv, np.asarray(jcl.v), rtol=1e-5,
                                   atol=1e-5)


def test_decode_only_and_prefill_only_plans():
    """An absent sub-batch (P == 0 or N == 0) is skipped, as JAX traces
    no machinery for it; the ids of the present one are unchanged."""
    _, tc = configs("narrow")
    rng = np.random.default_rng(4)
    model = TT.init_params(tc, torch.Generator().manual_seed(1), "cpu")
    arrs, _ = _mixed_plan(tc, rng)
    t = [torch.from_numpy(a) for a in arrs]

    def run(pre_rows, dec_rows):
        cache = TT.init_paged_cache(tc, 4, 16, 16, device="cpu")
        rows = [pre_rows] * 6 + [dec_rows] * 3 + [pre_rows, dec_rows]
        return TT.fused_serve_forward(
            model, tc, cache, *(a[r] for a, r in zip(t, rows)))
    both = run(slice(None), slice(None))
    pre_only = run(slice(None), slice(0, 0))
    # decode reads pages the prefill rows do not write, so a fresh cache
    # gives the decode rows the same inputs with or without the prefill
    dec_only = run(slice(0, 0), slice(None))
    assert pre_only.shape == (4,) and dec_only.shape == (4,)
    assert torch.equal(both[:4], pre_only)
    assert torch.equal(both[4:], dec_only)


@pytest.mark.parametrize("head", ["tie", "flat"])
def test_greedy_sampling_takes_the_first_max_inside_the_vocab(head):
    """Greedy ids come from ``logits[:, :vocab_size]`` and a tie goes to
    the lowest id, in both frameworks. The vocab (500) pads to 512; the
    padded columns carry large logits of both signs, so one of them
    would win if it were read. Every LM-head column is zero or a signed
    unit vector, so each logit is one hidden coordinate exactly and ties
    are exact whatever the GEMM's summation order. ``tie``: ids 3 and 5
    read coordinate 0 and id 4 its negation (3 wins where it is
    positive, 4 elsewhere); ``flat``: every vocab logit is 0 (id 0)."""
    jc, tc = (dataclasses.replace(c, vocab_size=500) for c in
              configs("narrow"))
    assert tc.vocab_padded == 512
    rng = np.random.default_rng(5)
    jp = jax.tree.map(np.asarray, JT.init_params(jax.random.PRNGKey(5), jc))
    lm = np.zeros_like(jp["lm_head"])
    if head == "tie":
        lm[0, 3] = lm[0, 5] = 1.0
        lm[0, 4] = -1.0
    lm[1, 500], lm[1, 511] = 1e3, -1e3
    jp["lm_head"] = lm
    model = TT.Transformer(tc, "cpu", torch.float32)
    model.load_state_dict(bridge.params_from_numpy(jp), strict=True)
    pages = [tuple(rng.standard_normal((16, 16, tc.num_kv_heads,
                                        tc.head_dim), np.float32)
                   for _ in range(2)) for _ in tc.layers]
    arrs, live = _mixed_plan(tc, rng)
    j = [jnp.asarray(a) for a in arrs]
    want, _ = JT.fused_serve_forward(
        jp, jc, {"layers": [JT.PagedAttnCache(jnp.asarray(k), jnp.asarray(v))
                            for k, v in pages]},
        *j[:9], pre_bt=j[9], dec_bt=j[10], attn_impl="jnp")
    t = [torch.from_numpy(a) for a in arrs]
    with torch.inference_mode():
        hid = TT._sampled_hidden(
            model, tc, bridge.paged_cache_from_numpy({"layers": pages},
                                                     device="cpu"), *t)
    ids = TT.fused_serve_forward(
        model, tc, bridge.paged_cache_from_numpy({"layers": pages},
                                                 device="cpu"), *t)
    expect = np.where(hid[:, 0].numpy() > 0, 3, 4) if head == "tie" \
        else np.zeros(len(live), np.int64)
    if head == "tie":                 # the tie occurred on a live row
        assert (expect[live] == 3).any()
    np.testing.assert_array_equal(ids.numpy()[live], expect[live])
    np.testing.assert_array_equal(np.asarray(want)[live], expect[live])
