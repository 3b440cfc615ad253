"""The encoder-decoder path (whisper-medium) and the vision frontend stub
(internvl2-76b) of the port against the JAX package's.

On ``.reduced(num_layers=2, d_model=128)`` configs (whisper-medium: one
encoder layer over 16 frame positions; internvl2-76b: 8 stub patches),
with the JAX weights carried across by ``repro_torch.bridge``, on the
same numpy inputs, CPU, f32:

- the registry gives JAX's configs field for field;
- ``bridge.params_from_numpy`` carries the encoder's leaves
  (``encoder.layers.*``, ``encoder.final_norm``) and the decoder's
  ``norm_cross`` and ``cross`` into ``Transformer`` with ``strict=True``,
  bit for bit;
- ``_encoder_forward`` on random frames, the cross caches it builds and
  ``_cross_attn`` over them: within 1e-5 (XLA and ATen sum in different
  orders); the cross caches' positions are equal;
- ``prefill`` with random frames (the encoder reruns on every call that
  carries them, as in JAX) and random patch embeddings, then
  ``decode_step``: logits within 1e-5;
- the fused engines refuse an encoder-decoder model and name the
  reference engine, as JAX's does; the serve script serves
  ``--arch whisper-medium --engine reference`` to its end and refuses
  the fused engine with that error;
- internvl2-76b's fused paged engine behind the scheduler streams what
  the JAX one streams (the stub zeroes each prefill chunk's leading
  positions in both).
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
from repro.models import transformer as JT  # noqa: E402
from repro.serving.schemes import make_jax_replica  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import NOT_PORTED, get_config  # noqa: E402
from repro_torch.core.qos import QoSSpec  # noqa: E402
from repro_torch.core.request import Request  # noqa: E402
from repro_torch.engine.torch_backend import (ReferenceTorchEngine,  # noqa
                                              TorchEngine)
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.serving.schemes import make_torch_replica  # noqa: E402

TOL = 1e-5


def _configs(arch):
    jc = jax_get_config(arch).reduced(num_layers=2, d_model=128)
    tc = get_config(arch).reduced(num_layers=2, d_model=128)
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    return jc, tc


def _both_params(arch, seed=5):
    jc, tc = _configs(arch)
    jparams = JT.init_params(jax.random.PRNGKey(seed), jc, jnp.float32)
    sd = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams))
    params = TT.Transformer(tc, torch.device("cpu"), torch.float32)
    params.load_state_dict(sd, strict=True)
    return jc, tc, jparams, params, sd


@pytest.mark.parametrize("arch", ["whisper-medium", "internvl2-76b"])
def test_configs_equal_jax_field_for_field(arch):
    assert dataclasses.asdict(get_config(arch)) == \
        dataclasses.asdict(jax_get_config(arch))
    assert arch not in NOT_PORTED


def test_bridge_carries_encoder_and_cross_leaves():
    jc, tc, jparams, params, sd = _both_params("whisper-medium")
    names = set(dict(params.named_parameters()))
    assert set(sd) == names
    for leaf in ("encoder.final_norm", "encoder.layers.0.norm1",
                 "encoder.layers.0.attn.wq", "encoder.layers.0.ffn.w_down",
                 "layers.1.norm_cross", "layers.1.cross.wq",
                 "layers.1.cross.wo"):
        assert leaf in names, leaf
    np.testing.assert_array_equal(
        params.encoder.layers[0].attn.wk.numpy(),
        np.asarray(jparams["encoder"]["layers"][0]["attn"]["wk"]))
    np.testing.assert_array_equal(
        params.layers[1].cross.wv.numpy(),
        np.asarray(jparams["layers"][1]["cross"]["wv"]))
    # the port's own init makes the same leaves, with JAX's shapes
    mine = TT.init_params(tc, torch.Generator().manual_seed(0), "cpu")
    assert {k: tuple(v.shape) for k, v in mine.named_parameters()} == \
        {k: tuple(v.shape) for k, v in sd.items()}


def test_encoder_and_cross_attention_match_jax():
    jc, tc, jparams, params, _ = _both_params("whisper-medium")
    rng = np.random.default_rng(0)
    B, P = 2, tc.encoder.num_positions
    frames = rng.standard_normal((B, P, tc.d_model), np.float32)
    jenc = JT._encoder_forward(jparams, jc, jnp.asarray(frames),
                               JT._identity_shard)
    tenc = TT._encoder_forward(params, tc, torch.from_numpy(frames))
    np.testing.assert_allclose(tenc.numpy(), np.asarray(jenc), rtol=0,
                               atol=TOL)
    jcache = JT.init_cache(jc, B, 64, dtype=jnp.float32)
    tcache = TT.init_cache(tc, B, 64, dtype=torch.float32, device="cpu")
    jcc = JT._build_cross_caches(jparams, jc, jenc, jcache)
    # the same encoder output into both, so that the caches compare alone
    tcc = TT._build_cross_caches(params, tc, torch.from_numpy(
        np.array(jenc)), tcache)
    x = rng.standard_normal((B, 5, tc.d_model), np.float32)
    for li in range(tc.num_layers):
        for name in ("k", "v"):
            np.testing.assert_allclose(
                getattr(tcc[li], name)[:B].numpy(),
                np.asarray(getattr(jcc[li], name)), rtol=0, atol=TOL)
        np.testing.assert_array_equal(tcc[li].pos[:B].numpy(),
                                      np.asarray(jcc[li].pos))
        want = JT._cross_attn(jparams["layers"][li]["cross"], jc,
                              jnp.asarray(x), jcc[li])
        got = TT._cross_attn(params.layers[li].cross, tc,
                             torch.from_numpy(x), tcc[li])
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=TOL)


@pytest.mark.parametrize("arch", ["whisper-medium", "internvl2-76b"])
def test_prefill_with_stubs_and_decode_match_jax(arch):
    """Two prefill chunks, each carrying random frames (the encoder and
    the cross caches rebuilt on each) or random patch embeddings (the
    leading positions of each chunk replaced), then two decode steps:
    logits within 1e-5."""
    jc, tc, jparams, params, _ = _both_params(arch)
    rng = np.random.default_rng(1)
    B = 2
    jcache = JT.init_cache(jc, B, 64, dtype=jnp.float32, chunk=64)
    tcache = TT.init_cache(tc, B, 64, dtype=torch.float32, chunk=64,
                           device="cpu")
    for S in (12, 9):
        if tc.encoder is not None:
            shape = (B, tc.encoder.num_positions, tc.d_model)
            key = "frames"
        else:
            shape = (B, tc.frontend.num_tokens, tc.d_model)
            key = "frontend_embeds"
        extra = rng.standard_normal(shape, np.float32)
        toks = rng.integers(0, tc.vocab_size, (B, S)).astype(np.int32)
        start = np.array(jcache["len"], np.int32)
        jl, jcache = JT.prefill(jparams, jc, jcache, jnp.asarray(toks),
                                jnp.asarray(start),
                                batch_extras={key: jnp.asarray(extra)},
                                serve=True)
        tl, tcache = TT.prefill(params, tc, tcache, torch.from_numpy(toks),
                                torch.from_numpy(start),
                                batch_extras={key: torch.from_numpy(extra)})
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                                   atol=TOL)
    last = np.array(jnp.argmax(jl[:, -1:, :tc.vocab_size], -1), np.int32)
    for _ in range(2):
        jl, jcache = JT.decode_step(jparams, jc, jcache, jnp.asarray(last),
                                    serve=True)
        tl, tcache = TT.decode_step(params, tc, tcache,
                                    torch.from_numpy(last))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                                   atol=TOL)
        last = np.array(jnp.argmax(jl[:, :, :tc.vocab_size], -1), np.int32)


def test_fused_path_refuses_encoder_decoder():
    _, tc = _configs("whisper-medium")
    for build in (lambda: TorchEngine(tc, device="cpu"),
                  lambda: TorchEngine(tc, kv_layout="dense", device="cpu"),
                  lambda: TT.init_paged_cache(tc, 2, 4, 16, device="cpu"),
                  lambda: make_torch_replica("niyama", tc, device="cpu")):
        with pytest.raises(NotImplementedError,
                           match="ReferenceTorchEngine"):
            build()
    eng = ReferenceTorchEngine(tc, n_slots=2, max_len=64, device="cpu")
    assert set(eng._extras(1)) == {"frames"}
    assert eng._extras(1)["frames"].dtype == torch.float32


def test_serve_whisper_through_the_reference_engine():
    rep = serve.main(["--device", "cpu", "--reduced", "--arch",
                      "whisper-medium", "--engine", "reference",
                      "--n-requests", "3", "--slots", "2", "--max-len",
                      "128", "--seed", "1"])
    assert isinstance(rep.backend, ReferenceTorchEngine)
    assert len(rep.finished) == 3
    for r in rep.finished:
        assert len(rep.backend.generated[r.rid]) == r.decode_len
    with pytest.raises(NotImplementedError, match="ReferenceTorchEngine"):
        serve.main(["--device", "cpu", "--reduced", "--arch",
                    "whisper-medium", "--n-requests", "1"])


class _FixedClock:
    """A constant iteration time, so that the two replicas make the same
    scheduling decisions."""

    def __init__(self, inner):
        self.inner = inner

    def execute(self, plan, now):
        self.inner.execute(plan, now)
        return 0.05

    def __getattr__(self, name):
        return getattr(self.inner, name)


def test_vision_fused_paged_streams_equal_jax():
    jc, tc = _configs("internvl2-76b")
    kw = dict(n_slots=2, max_len=128, block_size=16, quantum=16, seed=5)
    jrep = make_jax_replica("niyama", jc, backend_wrap=_FixedClock, **kw)
    sd = bridge.params_from_numpy(
        jax.tree.map(np.asarray, jrep.backend.inner.params))
    trep = make_torch_replica("niyama", tc, device="cpu", params=sd,
                              backend_wrap=_FixedClock, **kw)
    for rep, req_cls, qos_cls in ((jrep, JRequest, JQoS),
                                  (trep, Request, QoSSpec)):
        qos = qos_cls("q", interactive=True, ttft_slo=1e6, tbt_slo=1e6)
        rep.submit_all([req_cls(rid=i, arrival=0.15 * i,
                                prompt_len=18 + 23 * i,
                                decode_len=4 + (i % 3), qos=qos, app_id="a")
                        for i in range(4)])
        rep.run()
        assert len(rep.finished) == 4
    assert trep.backend.generated == jrep.backend.generated
