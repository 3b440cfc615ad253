"""The port's MoE FFN (``repro_torch.models.moe``) against the JAX
package's ``models/moe.py``, on the same numpy inputs and the JAX weights
carried across by ``repro_torch.bridge``; and the port's own contracts.

Configs: ``reduced(num_layers=2, d_model=128)`` of qwen3-moe-30b-a3b and
dbrx-132b (4 experts, top-2, d_ff_expert 256), both packages; 16 experts
where a test needs balanced and skewed routing on different rungs.

Tolerances (f32, CPU):

- against JAX, 4e-6 absolute on outputs of magnitude up to 2.4. XLA and
  ATen sum the products in different orders; the gap measured on these
  inputs is at most 9.5e-7.
- grouped against dropless inside torch: bit for bit.
- a token's output alone against its row in a batch: bit for bit when
  every expert product has at least two rows either way. A product of
  one row takes ATen's matrix-vector path on the CPU, whose sums differ
  in the last bits from the matrix product's (measured: at most 7.2e-7,
  as the JAX reference's own 6.0e-7, ROADMAP.md section 3): 2e-6 there.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import moe as JM  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.engine.torch_backend import TorchEngine  # noqa: E402
from repro_torch.models import moe as TM  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402

ARCHS = ["qwen3-moe-30b-a3b", "dbrx-132b"]
JAX_ATOL = 4e-6
SOLO_ATOL = 2e-6


def _configs(arch, experts=None):
    jc = jax_get_config(arch).reduced(num_layers=2, d_model=128)
    tc = get_config(arch).reduced(num_layers=2, d_model=128)
    if experts:
        jc = dataclasses.replace(jc, moe=dataclasses.replace(
            jc.moe, num_experts=experts))
        tc = dataclasses.replace(tc, moe=dataclasses.replace(
            tc.moe, num_experts=experts))
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    return jc, tc


def _moe(arch, seed=0, skew=0.0, experts=None):
    """The JAX config, params of layer 0's MoE, and the same weights as
    the port's ``MoE``; ``skew`` is added to expert 0's router column,
    ``experts`` replaces the config's number of experts."""
    jc, tc = _configs(arch, experts)
    jp = jax.tree.map(np.array, JT.init_params(jax.random.PRNGKey(seed), jc))
    jp["layers"][0]["moe"]["router"][:, 0] += skew
    model = TT.Transformer(tc, "cpu", torch.float32)
    model.load_state_dict(bridge.params_from_numpy(jp), strict=True)
    return jc, tc, {k: jnp.asarray(v) for k, v in
                    jp["layers"][0]["moe"].items()}, model.layers[0].moe


def _x(shape, d, seed):
    return np.random.default_rng(seed).normal(
        size=(*shape, d)).astype(np.float32)


def test_capacity_ladder_equals_jax():
    for E in (1, 2, 4, 8, 16, 128):
        for TK in range(1, 300):
            assert TM._capacity_ladder(TK, E) == JM._capacity_ladder(TK, E)
    assert TM._capacity_ladder(8 * 1024 * 8, 128) == \
        JM._capacity_ladder(8 * 1024 * 8, 128)


@pytest.mark.parametrize("shape", [(1, 1), (1, 7), (8, 1), (2, 33),
                                   (1, 256)])
@pytest.mark.parametrize("arch", ARCHS)
def test_grouped_and_dropless_match_jax(arch, shape):
    """Both serve paths against their JAX functions on the shapes of
    tests/test_moe_grouped.py (a decode token, decode batches, ragged
    prefill chunks), and grouped equal to dropless bit for bit."""
    jc, tc, jp, tp = _moe(arch)
    x = _x(shape, tc.d_model, seed=sum(shape))
    want_g = np.asarray(JM.moe_forward_grouped(jp, jnp.asarray(x), jc)[0])
    want_d = np.asarray(JM.moe_forward_dropless(jp, jnp.asarray(x), jc)[0])
    with torch.no_grad():
        got_g = TM.moe_forward_grouped(tp, torch.from_numpy(x), tc).numpy()
        got_d = TM.moe_forward_dropless(tp, torch.from_numpy(x), tc).numpy()
    np.testing.assert_allclose(got_g, want_g, rtol=0, atol=JAX_ATOL)
    np.testing.assert_allclose(got_d, want_d, rtol=0, atol=JAX_ATOL)
    np.testing.assert_array_equal(got_g, got_d)


@pytest.mark.parametrize("arch", ARCHS)
def test_grouped_identical_across_capacity_branches(arch):
    """16 experts, top-2, 32 tokens: the ladder is [4, 8, 16, 32, 64].
    Balanced routing takes a low rung; a router skewed to expert 0 (+10
    on its column) puts every token on that expert, the largest segment
    top-2 routing can make (T = 32 rows), and takes rung 32. Both take
    the rung JAX's ladder gives for their largest segment, equal the
    dropless sweep bit for bit, and JAX within tolerance. (x >= 0, so that
    the skew raises expert 0's logit for every token.)"""
    x = np.abs(_x((2, 16), 128, seed=11))
    segments, rungs = [], []
    for skew in (0.0, 10.0):
        jc, tc, jp, tp = _moe(arch, skew=skew, experts=16)
        TM.rungs.clear()
        with torch.no_grad():
            got = TM.moe_forward_grouped(tp, torch.from_numpy(x), tc)
            want = TM.moe_forward_dropless(tp, torch.from_numpy(x), tc)
            _, idx = TM._route(tp, torch.from_numpy(x), tc)
        (rung,) = TM.rungs
        torch.testing.assert_close(got, want, rtol=0, atol=0)
        np.testing.assert_allclose(
            got.numpy(),
            np.asarray(JM.moe_forward_grouped(jp, jnp.asarray(x), jc)[0]),
            rtol=0, atol=JAX_ATOL)
        E, K = tc.moe.num_experts, tc.moe.top_k
        mx = int(torch.bincount(idx.flatten(), minlength=E).max())
        ladder = JM._capacity_ladder(x.shape[0] * x.shape[1] * K, E)
        assert rung == next(c for c in ladder if c >= mx)
        segments.append(mx)
        rungs.append(rung)
    assert segments[0] < segments[1] == 32
    assert rungs[0] < rungs[1] == 32


@pytest.mark.parametrize("arch", ARCHS)
def test_token_output_does_not_depend_on_its_batch(arch):
    _, tc, _, tp = _moe(arch, seed=1)
    x = torch.from_numpy(_x((1, 64), tc.d_model, seed=3))
    with torch.no_grad():
        for fwd in (TM.moe_forward_grouped, TM.moe_forward_dropless):
            full = fwd(tp, x, tc)
            # 16 tokens: at least 8 rows a product either way
            for s in range(0, 64, 16):
                torch.testing.assert_close(fwd(tp, x[:, s:s + 16], tc),
                                           full[:, s:s + 16], rtol=0,
                                           atol=0)
            for t in range(6):
                torch.testing.assert_close(fwd(tp, x[:, t:t + 1], tc),
                                           full[:, t:t + 1], rtol=0,
                                           atol=SOLO_ATOL)


def test_top_k_ties_go_to_the_lower_index_as_jax():
    rng = np.random.default_rng(5)
    probs = rng.integers(0, 4, (64, 16)).astype(np.float32) / 4.0
    for k in (1, 2, 8):
        jv, ji = jax.lax.top_k(jnp.asarray(probs), k)
        tv, ti = TM._top_k(torch.from_numpy(probs), k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_jax_moe_tree_loads_strict_and_init_scales():
    """The JAX tree's ``layers.i.moe.{router,w_gate,w_up,w_down}`` load
    with ``strict=True``; the port's own init draws the MoE leaves at
    ``init_moe_params``'s scales (w_down at d_ff_expert ** -0.5, not
    d_ff ** -0.5)."""
    jc, tc = _configs("qwen3-moe-30b-a3b")
    jp = jax.tree.map(np.asarray, JT.init_params(jax.random.PRNGKey(0), jc))
    sd = bridge.params_from_numpy(jp)
    assert {"layers.1.moe.router", "layers.1.moe.w_gate",
            "layers.1.moe.w_up", "layers.1.moe.w_down"} <= set(sd)
    model = TT.init_params(tc, torch.Generator().manual_seed(0), "cpu")
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == \
        {k: tuple(v.shape) for k, v in sd.items()}
    moe = model.layers[1].moe
    d, f = tc.d_model, tc.moe.d_ff_expert
    assert f != tc.d_ff
    for name, std in (("router", d ** -0.5), ("w_gate", d ** -0.5),
                      ("w_up", d ** -0.5), ("w_down", f ** -0.5)):
        assert abs(float(getattr(moe, name).std()) / std - 1) < 0.02, name
    model.load_state_dict(sd, strict=True)
    np.testing.assert_array_equal(model.layers[1].moe.w_down.numpy(),
                                  jp["layers"][1]["moe"]["w_down"])


def test_grouped_counts_one_rung_per_call():
    """Each grouped call reads its largest segment on the host once and
    counts its rung; the dropless sweep reads nothing."""
    _, tc, _, tp = _moe("qwen3-moe-30b-a3b")
    x = torch.from_numpy(_x((2, 5), tc.d_model, seed=0))
    TM.rungs.clear()
    with torch.no_grad():
        TM.moe_forward_grouped(tp, x, tc)
        TM.moe_forward_dropless(tp, x, tc)
    assert sum(TM.rungs.values()) == 1
    (rung,) = TM.rungs
    assert rung in TM._capacity_ladder(10 * tc.moe.top_k,
                                       tc.moe.num_experts)


def test_engine_moe_impl_dropless_serves_the_grouped_stream():
    """``TorchEngine(moe_impl=...)``: both FFNs stream the same tokens on
    the same weights; an unknown name is refused."""
    from repro_torch.core.qos import QoSSpec
    from repro_torch.core.request import Request
    from repro_torch.core.scheduler import BatchPlan
    _, tc = _configs("qwen3-moe-30b-a3b")
    qos = QoSSpec("q", interactive=True, ttft_slo=1e6, tbt_slo=1e6)
    streams = []
    for impl in ("grouped", "dropless"):
        eng = TorchEngine(tc, n_slots=2, max_len=64, quantum=16,
                          block_size=16, seed=3, device="cpu",
                          moe_impl=impl)
        reqs = [Request(rid=i, arrival=0.0, prompt_len=20 + 9 * i,
                        decode_len=4, qos=qos) for i in range(2)]
        for r in reqs:
            eng.on_admit(r)
        eng.execute(BatchPlan(prefill=[(r, r.prompt_len) for r in reqs]),
                    0.0)
        for r in reqs:
            r.prefilled = r.prompt_len
        for _ in range(3):
            eng.execute(BatchPlan(decode=reqs), 0.0)
        streams.append(eng.generated)
    assert streams[0] == streams[1]
    assert all(len(g) == 4 for g in streams[0].values())
    with pytest.raises(ValueError, match="moe_impl"):
        TorchEngine(tc, device="cpu", moe_impl="capacity")
