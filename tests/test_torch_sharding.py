"""The port's sharding rules and launch tools against the JAX package's,
on the CPU: the twins of tests/test_sharding_launch.py, and parity.

- ``ShardingRules.param_spec`` for every ``state_dict`` name of every
  arch, train and serve, on the 16x16 and 2x16x16 meshes, equal to JAX's
  ``PartitionSpec`` for the same path (JAX's parameters from
  ``jax.eval_shape``, the port's on the meta device, each built once per
  arch); every port spec divides its axes;
- the rule twins: the non-divisible-heads fallback, ``lm_head`` train
  against serve, ``long_500k`` sharding the cache seq on both axes;
- ``cache_specs`` equal to JAX's for JAX's five archs x two shapes, and
  ``act_spec``, ``logits_spec``, ``data_specs`` and ``batch_shapes``
  for every (arch x shape);
- the host-mesh steps (``make_host_mesh("cpu")``, ``shard_fn`` on plain
  tensors): prefill, serve and train bit-equal to the unsharded port
  steps, and within 1e-5 (logits) of JAX's unsharded steps, the AdamW
  first moments (the clipped gradients) within 1e-4 of each leaf's
  largest magnitude and the parameters within the training tests'
  ``PARAM_TOL``;
- a DTensor off the CPU raises in ``kernels.ops`` rather than reach a
  kernel; importing ``launch.dryrun`` makes no process group; the
  hillclimb's levers (``no_fsdp``, the capacity and group-size
  patches).

A shape-only mesh stands in where no process group is needed.
"""
import dataclasses
import functools
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.distributed import sharding as JSH  # noqa: E402
from repro.engine import optim as JO  # noqa: E402
from repro.engine import steps as JS  # noqa: E402
from repro.launch import specs as JSP  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import ARCH_IDS, SHAPES, SKIPS, get_config  # noqa
from repro_torch.distributed import sharding as SH  # noqa: E402
from repro_torch.distributed import torch_api as ta  # noqa: E402
from repro_torch.engine import optim as TO  # noqa: E402
from repro_torch.engine import steps as TS  # noqa: E402
from repro_torch.launch import hillclimb as HC  # noqa: E402
from repro_torch.launch import specs as TSP  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402


class FakeMesh:
    """Shape-only stand-in for a mesh (no devices, no process group)."""

    def __init__(self, shape):
        self.axis_names = tuple(shape)
        self.shape = dict(shape)


MESHES = {"16x16": FakeMesh({"data": 16, "model": 16}),
          "2x16x16": FakeMesh({"pod": 2, "data": 16, "model": 16})}
MESH = MESHES["16x16"]
PAIRS = [(a, s) for a in ARCH_IDS for s in SHAPES if (a, s) not in SKIPS]
CACHE_PAIRS = [(a, s) for a in ("granite-8b", "jamba-v0.1-52b", "gemma3-4b",
                                "mamba2-370m", "whisper-medium")
               for s in ("decode_32k", "long_500k") if (a, s) not in SKIPS]


def _name(path) -> str:
    return ".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                    for k in path)


@functools.lru_cache(maxsize=None)
def _jax_params(arch):
    cfg = jax_get_config(arch)
    return jax.eval_shape(
        lambda: JT.init_params(jax.random.PRNGKey(0), cfg, jnp.bfloat16))


@functools.lru_cache(maxsize=None)
def _port_params(arch):
    return TT.Transformer(get_config(arch), "meta", torch.bfloat16)


def _dims_ok(spec, shape, mesh):
    for i, ax in enumerate(spec):
        if ax is not None:
            assert shape[i] % SH._axsize(mesh, ax) == 0, (spec, shape, i)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_equal_jax(arch, train, mesh):
    m = MESHES[mesh]
    jrules = JSH.ShardingRules(jax_get_config(arch), m, train=train)
    want = {_name(p): s for p, s in jax.tree_util.tree_flatten_with_path(
        jrules.param_specs(_jax_params(arch)),
        is_leaf=lambda x: isinstance(x, JP))[0]}
    got = SH.ShardingRules(get_config(arch), m, train=train).param_specs(
        _port_params(arch))
    assert set(got) == set(want)
    for n, spec in got.items():
        assert isinstance(spec, SH.P)
        assert tuple(spec) == tuple(want[n]) and spec == want[n], n


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_divide_evenly(arch, train):
    rules = SH.ShardingRules(get_config(arch), MESH, train=train)
    params = _port_params(arch)
    specs = rules.param_specs(params)
    assert specs
    for n, p in params.named_parameters():
        _dims_ok(specs[n], p.shape, MESH)


def test_non_divisible_heads_fall_back_to_replicated():
    rules = SH.ShardingRules(get_config("gemma3-4b"), MESH, train=False)
    assert rules.param_spec(("layers", "0", "attn", "wq"), None)[1] is None
    rules2 = SH.ShardingRules(get_config("granite-8b"), MESH, train=False)
    assert rules2.param_spec(("layers", "0", "attn", "wq"),
                             None)[1] == "model"


def test_lm_head_train_vs_infer():
    cfg = get_config("llama3.2-3b")
    assert SH.ShardingRules(cfg, MESH, train=False).param_spec(
        ("lm_head",), None) == SH.P(None, "model")
    tr = SH.ShardingRules(cfg, MESH, train=True).param_spec(("lm_head",),
                                                            None)
    assert tr[1] is None                 # vocab whole; logits seq-sharded


def test_long_500k_cache_is_fully_seq_sharded():
    shape = SHAPES["long_500k"]
    cfg = get_config("granite-8b", shape)     # swa_500k variant
    cache = TSP.cache_template(cfg, shape)
    specs = SH.ShardingRules(cfg, MESH, train=False).cache_specs(
        cache, 1, long_context=True)
    assert specs["layers"][0].k[1] == ("data", "model")


@pytest.mark.parametrize("arch,shape_name", CACHE_PAIRS)
def test_cache_specs_equal_jax(arch, shape_name):
    shape = SHAPES[shape_name]
    long = shape_name == "long_500k"
    jcfg = jax_get_config(arch, shape)
    jcache = JSP.cache_template(jcfg, shape)
    want = JSH.ShardingRules(jcfg, MESH, train=False).cache_specs(
        jcache, shape.global_batch, long_context=long)
    cfg = get_config(arch, shape)
    cache = TSP.cache_template(cfg, shape)
    got = SH.ShardingRules(cfg, MESH, train=False).cache_specs(
        cache, shape.global_batch, long_context=long)
    assert set(got) == set(want)
    for key in got:
        if key == "len":
            assert got[key] == want[key]
            continue
        assert len(got[key]) == len(want[key])
        for g, w, c in zip(got[key], want[key], cache[key]):
            assert type(g).__name__ == type(w).__name__
            assert tuple(g) == tuple(w), (key, g, w)
            for spec, t in zip(g, c):      # the batch rows, sink dropped
                _dims_ok(spec, (shape.global_batch,) + tuple(t.shape[1:]),
                         MESH)


@pytest.mark.parametrize("arch,shape_name", PAIRS)
def test_act_logits_data_specs_and_batch_shapes_equal_jax(arch,
                                                          shape_name):
    shape = SHAPES[shape_name]
    train = shape.kind == "train"
    jcfg, cfg = jax_get_config(arch, shape), get_config(arch, shape)
    jr = JSH.ShardingRules(jcfg, MESH, train=train)
    r = SH.ShardingRules(cfg, MESH, train=train)
    for kind in ("residual", "expert_buffer", "moe_group", "tokens",
                 "logits", "tp_heads"):
        assert r.act_spec(kind) == jr.act_spec(kind), kind
    assert r.logits_spec(shape.global_batch) == \
        jr.logits_spec(shape.global_batch)
    bs = TSP.batch_shapes(cfg, shape)
    assert bs == JSP.batch_shapes(jcfg, shape)
    assert r.data_specs(bs) == jr.data_specs(bs)
    specs = TSP.input_specs(cfg, shape)
    jspecs = JSP.input_specs(jcfg, shape)
    assert {k: tuple(v.shape) for k, v in specs.items()} == \
        {k: tuple(v.shape) for k, v in jspecs.items()}
    assert all(v.device.type == "meta" for v in specs.values())


def test_placements_follow_the_spec():
    class M:                  # the placements read axis names and sizes
        mesh_dim_names = ("pod", "data", "model")
        shape = (2, 16, 16)
    got = SH.placements(SH.P(("pod", "data"), None, "model"), M)
    assert got == (ta.Shard(0), ta.Shard(0), ta.Shard(2))
    assert SH.placements(SH.P(), M) == (ta.Replicate(),) * 3


# ---------------------------------------------------------------- imports


def test_dryrun_import_makes_no_process_group():
    """Each launch module's top level, run again (``importlib.reload``)
    before any test of this file has made a group, leaves none."""
    from repro_torch.launch import dryrun, mesh, roofline, specs
    assert not torch.distributed.is_initialized()
    for mod in (mesh, specs, roofline, dryrun, HC):
        importlib.reload(mod)
        assert not torch.distributed.is_initialized(), mod.__name__


# ---------------------------------------------------------------- host mesh

HOST_ARCHS = ("llama3.2-3b", "mamba2-370m")
B, S = 2, 16
LR = 1e-3
PARAM_TOL = 1e-3          # tests/test_torch_train.py's


def _cfgs(arch):
    jc = jax_get_config(arch).reduced(num_layers=2, d_model=128)
    tc = get_config(arch).reduced(num_layers=2, d_model=128)
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    return jc, tc


@functools.lru_cache(maxsize=None)
def _weights(arch):
    """Seeded weights as JAX's tree and as the port's ``state_dict``
    (drawn by the port, which is quicker than JAX's eager init)."""
    _, tc = _cfgs(arch)
    tree = bridge.params_to_numpy(TT.init_params(
        tc, torch.Generator().manual_seed(0), "cpu", torch.float32))
    return jax.tree.map(jnp.asarray, tree), bridge.params_from_numpy(tree)


def _load(arch):
    _, tc = _cfgs(arch)
    return TT.load_params(tc, _weights(arch)[1], device="cpu",
                          dtype=torch.float32)


def _tokens(cfg, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)


@pytest.fixture(scope="module")
def host_rules():
    from repro_torch.launch.mesh import make_host_mesh
    assert not torch.distributed.is_initialized()
    try:
        mesh = make_host_mesh("cpu")
        assert tuple(mesh.mesh_dim_names) == ("data", "model")
        assert tuple(mesh.shape) == (1, 1)
        yield {a: {t: SH.ShardingRules(_cfgs(a)[1], mesh, train=t)
                   for t in (True, False)} for a in HOST_ARCHS}
    finally:
        ta.destroy_group()


@pytest.mark.parametrize("arch", HOST_ARCHS)
def test_host_mesh_prefill_and_serve_steps(host_rules, arch):
    jc, tc = _cfgs(arch)
    rules = host_rules[arch][False]
    tok = _tokens(tc)
    out = {}
    for name, shard in (("mesh", rules.shard_fn()), ("plain", None)):
        kw = {} if shard is None else {"shard": shard}
        params = _load(arch)
        cache = TT.init_cache(tc, B, S + 2, dtype=torch.float32,
                              device="cpu")
        lg, cache = TS.make_prefill_step(tc, **kw)(
            params, cache, {"tokens": torch.from_numpy(tok)})
        nxt = TS.sample_greedy(lg, tc.vocab_size)
        lg2, _ = TS.make_serve_step(tc, **kw)(params, cache, nxt)
        out[name] = (lg, lg2)
    for a, b in zip(out["mesh"], out["plain"]):
        assert torch.equal(a, b)
    jp = _weights(arch)[0]
    jcache = JT.init_cache(jc, B, S + 2, dtype=jnp.float32)
    jlg, jcache = jax.jit(JS.make_prefill_step(jc))(
        jp, jcache, {"tokens": jnp.asarray(tok)})
    jnxt = JS.sample_greedy(jlg, jc.vocab_size)
    assert np.array_equal(np.asarray(jnxt), TS.sample_greedy(
        out["mesh"][0], tc.vocab_size).numpy())
    jlg2, _ = jax.jit(JS.make_serve_step(jc))(jp, jcache, jnxt)
    for a, b in ((out["mesh"][0], jlg), (out["mesh"][1], jlg2)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-5)


def test_host_mesh_train_step(host_rules):
    arch = "llama3.2-3b"
    jc, tc = _cfgs(arch)
    rules = host_rules[arch][True]
    rng = np.random.default_rng(1)
    nb = {"tokens": _tokens(tc),
          "labels": rng.integers(0, tc.vocab_size, (B, S)).astype(np.int32)}
    tb = {k: torch.from_numpy(v) for k, v in nb.items()}
    res = {}
    for name in ("mesh", "plain"):
        params = _load(arch)
        opt = TO.init_adamw(params)
        if name == "mesh":
            pls = {n: SH.placements(s, rules.mesh) for n, s in
                   rules.param_specs(params).items()}
            step = TS.make_train_step(tc, shard=rules.shard_fn(), lr=LR,
                                      grad_shardings=pls)
        else:
            step = TS.make_train_step(tc, lr=LR)
        params, opt, m = step(params, opt, tb)
        res[name] = (dict(params.named_parameters()), opt, m)
    (pm, om, mm), (pp, op, mp_) = res["mesh"], res["plain"]
    assert torch.equal(mm["loss"], mp_["loss"])
    assert torch.equal(mm["grad_norm"], mp_["grad_norm"])
    for n in pm:
        assert torch.equal(pm[n], pp[n]) and torch.equal(om.mu[n],
                                                         op.mu[n]), n
    jp = _weights(arch)[0]
    jb = {k: jnp.asarray(v) for k, v in nb.items()}
    jp2, jo, jm = jax.jit(JS.make_train_step(jc, lr=LR))(
        jp, JO.init_adamw(jp), jb)
    assert float(mm["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-5)
    jmu = bridge.params_from_numpy(jax.tree.map(np.asarray, jo.mu))
    jpar = bridge.params_from_numpy(jax.tree.map(np.asarray, jp2))
    for n, w in jmu.items():
        err = float((om.mu[n] - w).abs().max())
        assert err <= 1e-4 * float(w.abs().max()) + 1e-12, (n, err)
        assert float((pm[n].detach() - jpar[n]).abs().max()) < PARAM_TOL, n


def test_a_dtensor_never_reaches_a_kernel(host_rules):
    """Off the CPU a DTensor takes no kernel route: ``kernels.ops``
    raises, naming the op (a meta-device DTensor stands in for a card's
    here), and runs the plain version inside ``plain_versions()``."""
    from repro_torch.kernels import ops
    mesh = host_rules["llama3.2-3b"][False].mesh
    x = ta.DTensor.from_local(torch.empty(4, 8, device="meta"), mesh,
                              (ta.Replicate(), ta.Replicate()))
    w = ta.DTensor.from_local(torch.empty(8, device="meta"), mesh,
                              (ta.Replicate(), ta.Replicate()))
    with pytest.raises(NotImplementedError, match="rmsnorm: a DTensor"):
        ops.rmsnorm(x, w)
    with ops.plain_versions():
        assert ops.rmsnorm(x, w).shape == (4, 8)


# ---------------------------------------------------------------- hillclimb


@pytest.mark.parametrize("arch", ["llama3.2-3b", "qwen3-moe-30b-a3b"])
def test_no_fsdp_drops_the_data_axis(arch):
    rules = SH.ShardingRules(get_config(arch), MESH, train=True)
    HC.no_fsdp(rules)
    specs = rules.param_specs(_port_params(arch))
    assert all("data" not in s for s in specs.values())
    full = SH.ShardingRules(get_config(arch), MESH, train=True)
    assert any("data" in s for s in full.param_specs(
        _port_params(arch)).values())


def test_hillclimb_patches_are_seen_and_restored():
    from repro_torch.models import moe
    arch = "qwen3-moe-30b-a3b"
    before = get_config(arch)
    with HC.capacity_factor(arch, 1.0):
        assert get_config(arch).moe.capacity_factor == 1.0
        assert get_config(arch, "prefill_32k").moe.capacity_factor == 1.0
    assert get_config(arch) is before
    assert before.moe.capacity_factor != 1.0
    old = moe.GROUP_TOKENS
    with HC.group_tokens(2048):
        assert moe.GROUP_TOKENS == 2048 and moe._num_groups(8192) == 4
    assert moe.GROUP_TOKENS == old
