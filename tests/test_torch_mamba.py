"""The port's Mamba2 path against the JAX package's, on the same numpy
inputs and the JAX weights carried across by ``repro_torch.bridge``, at
``mamba2-370m.reduced(num_layers=2, d_model=128)`` (d_inner 256, 8 heads
of 32, d_state 32, chunk 32).

Tolerances (f32): 1e-5 for the mixer's outputs and states and for the
hidden states after two layers (summation order of XLA against ATen;
the readings are below 2e-6); exact for the masked-tail property inside
the port and for the sampled ids and token streams.
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
from repro.engine.jax_backend import JaxEngine  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import mamba2 as JM  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.qos import QoSSpec as TQoS  # noqa: E402
from repro_torch.core.request import Request as TRequest  # noqa: E402
from repro_torch.core.scheduler import BatchPlan as TPlan  # noqa: E402
from repro_torch.engine.torch_backend import TorchEngine  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import mamba2 as TM  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)


def configs():
    jc = jax_get_config("mamba2-370m").reduced(num_layers=2, d_model=128)
    tc = get_config("mamba2-370m").reduced(num_layers=2, d_model=128)
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    return jc, tc


def _mixer(seed=1):
    """The JAX mixer's weights and the port's Mamba module holding them."""
    jc, tc = configs()
    p = JM.init_mamba_params(jax.random.PRNGKey(seed), jc, jnp.float32)
    m = TM.Mamba(tc, "cpu", torch.float32)
    m.load_state_dict(bridge.params_from_numpy(jax.tree.map(np.asarray, p)),
                      strict=True)
    return jc, tc, p, m


def _states(rng, jc, batch):
    st = JM.init_mamba_state(batch, jc)
    conv = rng.standard_normal(st.conv.shape).astype(np.float32)
    ssm = rng.standard_normal(st.ssm.shape).astype(np.float32)
    return (JM.MambaState(jnp.asarray(conv), jnp.asarray(ssm)),
            TM.MambaState(torch.from_numpy(conv), torch.from_numpy(ssm)))


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **(tol or TOL))


@pytest.mark.parametrize("seq_lens", [None, (45, 13, 32)])
def test_mamba_forward_matches_jax(seq_lens):
    """Two chunks and a ragged third from a carried state, with and
    without a masked tail per row."""
    jc, tc, p, m = _mixer()
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 45, 128)).astype(np.float32)
    jst, tst = _states(rng, jc, 3)
    lens = None if seq_lens is None else np.asarray(seq_lens, np.int32)
    yj, sj = JM.mamba_forward(p, jnp.asarray(x), jc, jst, seq_lens=None
                              if lens is None else jnp.asarray(lens))
    yt, st = TM.mamba_forward(m, torch.from_numpy(x), tc, tst, seq_lens=None
                              if lens is None else torch.from_numpy(lens))
    _close(yt, yj)
    _close(st.conv, sj.conv)
    _close(st.ssm, sj.ssm)


def test_mamba_step_matches_jax():
    jc, tc, p, m = _mixer()
    rng = np.random.default_rng(1)
    x = rng.standard_normal((4, 1, 128)).astype(np.float32)
    jst, tst = _states(rng, jc, 4)
    yj, sj = JM.mamba_step(p, jnp.asarray(x), jc, jst)
    yt, st = TM.mamba_step(m, torch.from_numpy(x), tc, tst)
    assert yt.shape == (4, 1, 128)
    _close(yt, yj)
    _close(st.conv, sj.conv)
    _close(st.ssm, sj.ssm)


def test_masked_mamba_forward_bitwise():
    """The port's twin of tests/test_fused_engine.py's property: a row
    padded at the tail with ``seq_lens`` gives the same outputs and
    final state, bit for bit, as the exact-length call."""
    _, tc, _, m = _mixer()
    rng = np.random.default_rng(0)
    st = TM.init_mamba_state(1, tc, device="cpu")
    x = torch.from_numpy(rng.standard_normal((1, 11, 128)).astype(np.float32))
    xp = torch.cat([x, torch.from_numpy(rng.standard_normal(
        (1, 21, 128)).astype(np.float32))], dim=1)
    with torch.inference_mode():
        y, st1 = TM.mamba_forward(m, x, tc, st)
        yp, st2 = TM.mamba_forward(m, xp, tc, st, seq_lens=torch.tensor(
            [11], dtype=torch.int32))
    assert torch.equal(yp[:, :11], y)
    assert torch.equal(st2.conv, st1.conv)
    assert torch.equal(st2.ssm, st1.ssm)


def test_softplus_is_jax_logaddexp():
    x = np.linspace(-40, 40, 801, dtype=np.float32)
    _close(TM._softplus(torch.from_numpy(x)), jax.nn.softplus(jnp.asarray(x)),
           rtol=1e-6, atol=1e-7)


def test_init_params_names_and_values_match_jax():
    """The port's Mamba leaves carry the JAX tree's names and shapes
    (``layers.1.mamba.A_log`` ...), no norm2 or ffn, and the JAX init
    values where they are not random draws."""
    jc, tc = configs()
    jp = jax.tree.map(np.asarray, JT.init_params(jax.random.PRNGKey(0), jc))
    sd = bridge.params_from_numpy(jp)
    model = TT.init_params(tc, torch.Generator().manual_seed(0), "cpu")
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == \
        {k: tuple(v.shape) for k, v in sd.items()}
    assert "layers.1.mamba.A_log" in sd and "layers.1.ffn.w_up" not in sd
    assert "layers.0.norm2" not in sd and "lm_head" not in sd
    mb = model.layers[1].mamba
    for name in ("A_log", "D", "dt_bias", "conv_b", "norm_w"):
        np.testing.assert_allclose(getattr(mb, name).numpy(),
                                   jp["layers"][1]["mamba"][name], rtol=1e-6)
    assert abs(float(mb.conv_w.std()) - 0.1) < 0.01
    assert abs(float(mb.out_proj.std()) - 256 ** -0.5) < 0.01
    model.load_state_dict(sd, strict=True)


def _plan(cfg, rng, n_slots=5):
    """A first chunk (state reset), a chunk resuming slot 1's state at
    16, two pad rows (slot ``n_slots``: the sink row); 5 decode slots,
    slots 2 and 3 active, slot 4 idle. The arrays in
    ``fused_serve_forward``'s order."""
    P, L = 4, 32
    pre_tokens = rng.integers(0, cfg.vocab_size, (P, L)).astype(np.int32)
    pre_slots = np.array([0, 1, n_slots, n_slots], np.int32)
    pre_start = np.array([0, 16, 0, 0], np.int32)
    pre_len = np.array([20, 25, 0, 0], np.int32)
    pre_reset = np.array([True, False, False, False])
    pre_sample = np.array([19, 24, 0, 0], np.int32)
    dec_tokens = rng.integers(0, cfg.vocab_size, n_slots).astype(np.int32)
    dec_start = np.array([0, 16, 37, 5, 9], np.int32)
    dec_active = np.array([False, False, True, True, False])
    pre_bt = np.full((P, 2), -1, np.int32)
    dec_bt = np.full((n_slots, 2), -1, np.int32)
    live = np.r_[pre_len > 0, dec_active]
    return (pre_tokens, pre_slots, pre_start, pre_len, pre_reset,
            pre_sample, dec_tokens, dec_start, dec_active, pre_bt,
            dec_bt), live


def _jax_hidden(params, cfg, cache, pre_tokens, pre_slots, pre_start,
                pre_len, pre_reset, pre_sample, dec_tokens, dec_start,
                dec_active, pre_bt, dec_bt):
    """JAX's fused_serve_forward stopped before its LM head."""
    P, L = pre_tokens.shape
    x_pre = JT._embed(params, cfg, pre_tokens, None)
    x_dec = JT._embed(params, cfg, dec_tokens[:, None], None)
    pre_valid = jnp.arange(L)[None, :] < pre_len[:, None]
    for li, spec in enumerate(cfg.layers):
        x_pre, x_dec, _ = JT._fused_block(
            params["layers"][li], cfg, spec, x_pre, x_dec,
            cache["layers"][li], pre_slots, pre_start, pre_len, pre_reset,
            pre_valid, dec_start, dec_active, JT._identity_shard, "jnp",
            pre_bt=pre_bt, dec_bt=dec_bt)
    x_pre = JL.rmsnorm(x_pre, params["final_norm"], cfg.norm_eps)
    x_dec = JL.rmsnorm(x_dec, params["final_norm"], cfg.norm_eps)
    return jnp.concatenate([x_pre[jnp.arange(P), pre_sample], x_dec[:, 0]])


def test_fused_serve_forward_matches_jax():
    """One mixed iteration over slot states carried across: ids equal,
    hidden states and every slot's new state within 1e-5; the pad rows
    and inactive decode slots leave their rows as they were."""
    jc, tc = configs()
    rng = np.random.default_rng(2)
    jp = JT.init_params(jax.random.PRNGKey(3), jc)
    model = TT.Transformer(tc, "cpu", torch.float32)
    model.load_state_dict(bridge.params_from_numpy(
        jax.tree.map(np.asarray, jp)), strict=True)
    jcache = JT.init_paged_cache(jc, 5, 8, 16)
    jcache = {"layers": [JM.MambaState(
        jnp.asarray(rng.standard_normal(c.conv.shape).astype(np.float32)),
        jnp.asarray(rng.standard_normal(c.ssm.shape).astype(np.float32)))
        for c in jcache["layers"]]}
    before = jax.tree.map(np.asarray, jcache)
    arrs, live = _plan(tc, rng)
    j = [jnp.asarray(a) for a in arrs]
    want_ids, want_cache = JT.fused_serve_forward(
        jp, jc, jcache, *j[:9], pre_bt=j[9], dec_bt=j[10])
    want_hid = _jax_hidden(jp, jc, jcache, *j)

    t = [torch.from_numpy(a) for a in arrs]
    with torch.inference_mode():
        hid = TT._sampled_hidden(model, tc, bridge.paged_cache_from_numpy(
            before, device="cpu"), *t)
    cache = bridge.paged_cache_from_numpy(before, device="cpu")
    assert isinstance(cache["layers"][0], TM.MambaState)
    assert cache["layers"][0].ssm.shape[0] == 6      # 5 slots + the sink
    ids = TT.fused_serve_forward(model, tc, cache, *t)

    np.testing.assert_array_equal(ids.numpy()[live],
                                  np.asarray(want_ids)[live])
    _close(hid[torch.from_numpy(live)], np.asarray(want_hid)[live])
    got = bridge.paged_cache_to_numpy(cache)["layers"]
    for (conv, ssm), wc, old in zip(got, want_cache["layers"],
                                    before["layers"]):
        np.testing.assert_allclose(conv, np.asarray(wc.conv), **TOL)
        np.testing.assert_allclose(ssm, np.asarray(wc.ssm), **TOL)
        # slot 4 is neither prefilled nor an active decode: untouched
        np.testing.assert_array_equal(ssm[4], old.ssm[4])
        np.testing.assert_array_equal(conv[4], old.conv[4])
    for c in cache["layers"]:          # pad rows leave the sink as it was
        assert float(c.ssm[-1].abs().max()) == 0.0


def _drive_plans(engine, req_cls, plan_cls, qos):
    """The plan sequence of tests/test_fused_engine.py::drive_plans:
    multi-chunk prefill, a prefill completing while a decode batch is
    live, joint decode, and slot reuse after release. Returns rid ->
    stream length."""
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
    r2 = req_cls(rid=2, arrival=0.0, prompt_len=21, decode_len=3, qos=qos)
    engine.on_admit(r2)
    engine.execute(plan_cls(prefill=[(r2, 21)]), 0.0)
    r2.prefilled = 21
    engine.execute(plan_cls(decode=[r2]), 0.0)
    engine.execute(plan_cls(decode=[r2]), 0.0)
    engine.on_release(r2)
    return {0: 5, 1: 5, 2: 3}


def test_torch_engine_streams_equal_jax_engine_on_drive_plans():
    """TorchEngine and JaxEngine (paged, block_size 32, quantum 16) on
    the same weights and plans stream the same greedy tokens, slot reuse
    included: a fresh request on a just-freed slot sees no state of the
    previous occupant."""
    jc, tc = configs()
    jeng = JaxEngine(jc, n_slots=2, max_len=128, quantum=16, seed=7,
                     kv_layout="paged", block_size=32)
    teng = TorchEngine(tc, n_slots=2, max_len=128, quantum=16, seed=7,
                       block_size=32, device="cpu",
                       params=bridge.params_from_numpy(
                           jax.tree.map(np.asarray, jeng.params)))
    want = _drive_plans(jeng, JRequest, JPlan, JQoS("q", interactive=True,
                                                    ttft_slo=1e6,
                                                    tbt_slo=1e6))
    _drive_plans(teng, TRequest, TPlan, TQoS("q", interactive=True,
                                             ttft_slo=1e6, tbt_slo=1e6))
    for rid, n in want.items():
        assert len(jeng.generated[rid]) == n
        assert teng.generated[rid] == jeng.generated[rid], rid


def test_warm_leaves_every_state_row_as_it_was():
    """warm() runs the Mamba path on a pad row bound to the sink row and
    an inactive decode batch: no slot's state moves, and the norm and
    scan run (here their plain versions)."""
    _, tc = configs()
    eng = TorchEngine(tc, n_slots=3, max_len=64, quantum=16, block_size=16,
                      device="cpu")
    gen = torch.Generator().manual_seed(0)
    for c in eng.cache["layers"]:
        c.conv.normal_(generator=gen)
        c.ssm.normal_(generator=gen)
    before = [(c.conv.clone(), c.ssm.clone()) for c in eng.cache["layers"]]
    ops.reset_counts()
    eng.warm()
    counts = ops.counts()
    assert counts["ssd_scan"] == {"launches": 0, "plain": tc.num_layers}
    assert counts["rmsnorm"]["plain"] == 2 * tc.num_layers + 1
    for (conv, ssm), c in zip(before, eng.cache["layers"]):
        assert torch.equal(conv, c.conv) and torch.equal(ssm, c.ssm)
    ops.reset_counts()


def test_prefix_sharing_is_off_for_mamba_families():
    _, tc = configs()
    llama = get_config("llama3.2-3b").reduced(num_layers=2, d_model=128)
    assert not TorchEngine(tc, n_slots=2, max_len=64, quantum=16,
                           block_size=16, device="cpu").prefix_sharing_ok
    assert TorchEngine(llama, n_slots=2, max_len=64, quantum=16,
                       block_size=16, device="cpu").prefix_sharing_ok
