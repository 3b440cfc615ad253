"""Tensor-parallel serving in the port: the twins of
tests/test_sharded_engine.py's bit-identity tests at TP = 2, and the
plan's pieces against the JAX package's ``TPServePlan``.

``TorchEngine(tp=N)`` is rank 0 of N processes joined over gloo (spawned
here, on the CPU): each rank holds its slice of the heads, the dense
d_ff, the experts and the vocab and its kv-heads of every cache, and the
serve forward all-gathers the slices before every combine. At the
reduced widths of JAX's file (``.reduced(num_layers=2, d_model=64)``), a
slice of a CPU GEMM's output columns is bit for bit the same slice of
the whole product, so the tolerance of every stream comparison here is
none: TP = N streams equal tp = 1 streams exactly, in f32, as in JAX.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.distributed.tp_serve import TPServePlan as JaxPlan  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.qos import QoSSpec  # noqa: E402
from repro_torch.core.request import Request  # noqa: E402
from repro_torch.core.scheduler import BatchPlan  # noqa: E402
from repro_torch.distributed import TPServePlan  # noqa: E402
from repro_torch.engine.torch_backend import make_engine  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402

QOS = QoSSpec("q", interactive=True, ttft_slo=1e6, tbt_slo=1e6)

FAMILIES = [
    "llama3.2-3b",        # dense attention
    "qwen3-moe-30b-a3b",  # MoE
    "jamba-v0.1-52b",     # Mamba2 hybrid
]


def reduced(arch):
    return get_config(arch).reduced(num_layers=2, d_model=64)


def drive(engine, n_req=2, max_new=3):
    """JAX's session over hand-built plans: chunked prefill on the
    quantum grid, then joint decode."""
    reqs = [Request(rid=i, arrival=0.0, prompt_len=17 + 11 * i,
                    decode_len=max_new, qos=QOS) for i in range(n_req)]
    for r in reqs:
        engine.on_admit(r)
    while any(r.prefilled < r.prompt_len for r in reqs):
        plan = BatchPlan()
        for r in reqs:
            if r.prefilled < r.prompt_len:
                plan.prefill.append(
                    (r, min(engine.quantum, r.prompt_len - r.prefilled)))
            elif engine.generated[r.rid]:
                plan.decode.append(r)
        engine.execute(plan, 0.0)
        for r, c in plan.prefill:
            r.prefilled += c
    for _ in range(max_new - 1):
        engine.execute(BatchPlan(decode=list(reqs)), 0.0)
    return {r.rid: list(engine.generated[r.rid]) for r in reqs}


def _pair_streams(cfg, tp, **kw):
    """(tp=1 streams, TP engine's streams, tp=1 engine, TP engine) on the
    tp=1 engine's weights; the TP engine's ranks are stopped."""
    kw = dict(n_slots=2, max_len=128, quantum=16, seed=7, device="cpu",
              **kw)
    base = make_engine("fused", cfg, **kw)
    want = drive(base)
    eng = make_engine("fused", cfg, tp=tp,
                      params=base.params.state_dict(), **kw)
    try:
        got = drive(eng)
    finally:
        eng.close()
    return want, got, base, eng


# ---------------------------------------------------------------- identity
@pytest.mark.parametrize("layout", ["paged", "dense"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_tp2_bit_identity(arch, layout):
    """Tolerance: none (f32 streams equal bit for bit). The bucket
    lattice does not depend on tp."""
    want, got, base, tp2 = _pair_streams(reduced(arch), 2, kv_layout=layout)
    assert got == want, f"{arch}/{layout}: tp=2 diverged"
    assert tp2.buckets_seen == base.buckets_seen
    assert tp2.jit_compiles == base.jit_compiles
    assert tp2.tp_collective_bytes      # real traffic, priced as JAX's


@pytest.mark.parametrize("arch", ["llama3.2-3b", "jamba-v0.1-52b"])
def test_tp2_int8_kv_pages_bit_identity(arch):
    """Sharded int8 pages: a rank quantizes and reads only its kv-heads
    (one scale per token and head), so int8 serving at TP = 2 streams
    what its tp=1 twin streams, bit for bit."""
    want, got, _, _ = _pair_streams(reduced(arch), 2, kv_layout="paged",
                                    block_size=32, kv_quant=True)
    assert got == want, f"{arch}: int8-KV tp=2 diverged"


def test_tp3_non_divisible_falls_back_to_replication():
    """tp=3 divides nothing in the reduced geometry: every family of
    parameters replicates, no gather runs, and the engine serves the
    tp=1 streams rather than failing."""
    cfg = reduced("llama3.2-3b")
    plan = TPServePlan(cfg, 3)
    assert not any(plan.sharded_dims.values())
    want, got, _, tp3 = _pair_streams(cfg, 3, kv_layout="paged",
                                      block_size=32)
    assert got == want
    assert tp3.tp_collective_bytes == {}


# ------------------------------------------------------------- the plan
def _names(cfg):
    return [n for n, _ in TT.Transformer(cfg, "meta", torch.float32)
            .named_parameters()]


@pytest.mark.parametrize("tp", [2, 3, 4])
@pytest.mark.parametrize("arch", FAMILIES + ["dbrx-132b", "gemma3-4b"])
def test_plan_matches_jax(arch, tp):
    """The divisibility flags, each parameter's sharded dim and the
    collective-byte account equal the JAX plan's (exact)."""
    cfg = reduced(arch)
    jcfg = jax_get_config(arch).reduced(num_layers=2, d_model=64)
    jplan, plan = JaxPlan(jcfg, tp), TPServePlan(cfg, tp)
    assert plan.sharded_dims == jplan.sharded_dims
    tree = jax.eval_shape(lambda: JT.init_params(jax.random.PRNGKey(0),
                                                 jcfg))
    want = {}
    for kp, _ in jax.tree_util.tree_flatten_with_path(tree)[0]:
        path = tuple(str(getattr(k, "key", getattr(k, "idx", None)))
                     for k in kp)
        spec = tuple(jplan._param_spec(path))
        want[".".join(path)] = next(
            (i for i, a in enumerate(spec) if a is not None), None)
    assert {n: plan.param_dim(n) for n in _names(cfg)} == want
    for n_tok, rows in ((1, 1), (40, 2), (517, 9)):
        for bpe in (2, 4):
            assert plan.collective_bytes(n_tok, rows, bpe) == \
                jplan.collective_bytes(n_tok, rows, bpe)


def test_shards_join_to_the_whole():
    """``bridge.rank_params_to_numpy`` cuts JAX's weights by the plan, f32
    and bf16, and ``tensor_from_numpy`` reads them back with their
    dtype: the ranks' slices of a sharded weight concatenate, in rank
    order, to the whole; a replicated one is the whole on every rank.
    The page payload's kv-head slices join back the same way (exact)."""
    cfg = reduced("qwen3-moe-30b-a3b")
    jcfg = jax_get_config("qwen3-moe-30b-a3b").reduced(num_layers=2,
                                                       d_model=64)
    tree = jax.tree.map(np.asarray,
                        JT.init_params(jax.random.PRNGKey(3), jcfg))
    plan = TPServePlan(cfg, 2)
    for whole in (bridge.params_from_numpy(tree),
                  {k: v.to(torch.bfloat16) for k, v in
                   bridge.params_from_numpy(tree).items()}):
        shards = [{k: bridge.tensor_from_numpy(v) for k, v in
                   bridge.rank_params_to_numpy(whole, plan, r).items()}
                  for r in range(2)]
        for name, t in whole.items():
            d = plan.param_dim(name)
            assert all(s[name].dtype == t.dtype for s in shards), name
            if d is None:
                assert all(torch.equal(s[name], t) for s in shards), name
            else:
                assert shards[0][name].shape[d] * 2 == t.shape[d]
                assert torch.equal(torch.cat([s[name] for s in shards], d),
                                   t)
    g = torch.Generator().manual_seed(0)
    pages = {0: (torch.randn(3, 16, 4, 16, generator=g),
                 torch.randn(3, 16, 4, 16, generator=g),
                 torch.rand(3, 16, 4, generator=g).to(torch.bfloat16),
                 torch.rand(3, 16, 4, generator=g).to(torch.bfloat16))}
    cut = [plan.shard_pages(pages, r) for r in range(2)]
    assert cut[1][0][2].shape == (3, 16, 2)
    joined = plan.join_pages(cut)
    assert all(torch.equal(a, b) for a, b in zip(joined[0], pages[0]))


def test_plan_refuses_tp1():
    with pytest.raises(ValueError, match="tp >= 2"):
        TPServePlan(reduced("llama3.2-3b"), 1)


@pytest.mark.parametrize("sliced", [False, True])
def test_load_params_checks_each_shape(sliced):
    """``load_params`` builds on the meta device for one rank or many:
    a whole ``state_dict`` (cut by the rank's rule, identity at tp = 1)
    or a rank's slices (``sliced``) load as copies, bit for bit; an
    entry of the wrong shape raises, naming it, and so does a slice cut
    for another degree."""
    cfg = reduced("qwen3-moe-30b-a3b")
    whole = TT.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    sd = {k: v.detach().clone() for k, v in whole.state_dict().items()}
    plan = TPServePlan(cfg, 2)
    rank = 1 if sliced else 0

    def shard(name, t):
        return plan.shard_param(name, t, rank)
    cut = {k: shard(k, v) for k, v in sd.items()}
    # (entries, rule, what loads)
    cases = [(cut, shard, cut)] if sliced else [(sd, None, sd),
                                                 (sd, shard, cut)]
    for src, rule, want in cases:
        got = TT.load_params(cfg, src, "cpu", shard=rule,
                             sliced=sliced).state_dict()
        assert got.keys() == want.keys()
        for k, v in got.items():
            assert torch.equal(v, want[k]), k
            assert v.data_ptr() != src[k].data_ptr(), k
    bad = dict(cut if sliced else sd)
    bad["layers.0.attn.wq"] = bad["layers.0.attn.wq"][:, :1]
    with pytest.raises(ValueError, match="layers.0.attn.wq"):
        TT.load_params(cfg, bad, "cpu", shard=shard if sliced else None,
                       sliced=sliced)
    if sliced:
        other = TPServePlan(cfg, 4)
        four = {k: other.shard_param(k, v, 0) for k, v in sd.items()}
        with pytest.raises(ValueError, match="slice"):
            TT.load_params(cfg, four, "cpu", shard=shard, sliced=True)
