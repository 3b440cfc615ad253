"""The sharded program runs: four spawned gloo ranks on the CPU form a
(2, 2) ("data", "model") DeviceMesh and run the reduced llama3.2-3b,
qwen3-moe-30b-a3b and jamba-v0.1-52b (``.reduced()``, f32) with their
parameters, batch and cache as DTensors placed by ``ShardingRules``:

- one train step with ``shard=`` and ``grad_shardings=`` against the
  unsharded step in one process: loss within 1e-6 relative, the AdamW
  first moments (the clipped gradients times 1 - b1) within 1e-5 of each
  leaf's largest magnitude, and so are the updated parameters wherever
  the gradient is at least 1e-3 of its leaf's largest. The sharded
  step's reduce-scatters and all-reduces add the gradients' partial sums
  in another order, so the result is close, not equal bit for bit; and
  AdamW's first step normalises each gradient by its own magnitude
  (``m / (sqrt(v) + eps)``), so where a gradient is ~1e-9 that order
  moves the update by up to ``lr`` itself: there the parameters are
  held to 2 lr, the most one step can move them apart;
- one sharded prefill and one decode step, whose greedy tokens equal
  the unsharded steps';
- the dry-run's counts (``launch.dryrun.measure_step`` over the same
  mesh, on meta tensors) of each collective, by op, equal those that
  ``CommDebugMode`` counts in the real train step and decode step.

The ranks are spawned once for all cases (a module fixture); each case
reads the results the ranks sent back. Once the sharded steps of all
three archs have run, each arch's dry-run is traced on one of ranks 0-2
(``_tracer``) and its unsharded twin runs on one of ranks 1-3
(``_checker``), the ranks' local jobs side by side.
"""
import multiprocessing as mp
import os
import queue
import tempfile
import time

import pytest

torch = pytest.importorskip("torch")

ARCHS = ("llama3.2-3b", "qwen3-moe-30b-a3b", "jamba-v0.1-52b")
WORLD = 4
B, S, DECODES = 4, 32, 1
LR = 3e-4
TIMEOUT_S = 120.0


def _counts(comm_counts) -> dict:
    """CommDebugMode's counts by the dry-run's op names."""
    from repro_torch.launch.dryrun import _COLLECTIVES
    out = {}
    for op, n in comm_counts.items():
        name = _COLLECTIVES.get(getattr(op, "__name__", str(op)))
        if name and n:
            out[name] = out.get(name, 0) + n
    return out


def _checker(arch) -> int:
    """The rank that holds ``arch``'s unsharded twin and compares: the
    three archs on ranks 1-3."""
    return 1 + ARCHS.index(arch) % (WORLD - 1)


def _tracer(arch) -> int:
    """The rank that traces ``arch``'s dry-run: the three archs on ranks
    0-2, so that with the twins each rank has at most two local jobs."""
    return ARCHS.index(arch)


def _inputs(arch):
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import init_params

    cfg = get_config(arch).reduced()
    tokens = torch.randint(0, cfg.vocab_size, (B, S),
                           generator=torch.Generator().manual_seed(1),
                           dtype=torch.int64).to(torch.int32)
    batch = {"tokens": tokens, "labels": tokens.roll(-1, dims=1)}

    def fresh():
        return init_params(cfg, torch.Generator().manual_seed(0), "cpu",
                           torch.float32)
    return cfg, tokens, batch, fresh


def _run_sharded(arch, mesh):
    """The sharded train, prefill and decode steps, on every rank."""
    from repro_torch.distributed import sharding as SH
    from repro_torch.distributed import torch_api as ta
    from repro_torch.engine import steps as ST
    from repro_torch.engine.optim import init_adamw, named_leaves
    from repro_torch.models.transformer import init_cache

    cfg, tokens, batch, fresh = _inputs(arch)
    out = {}
    # ---- the train step
    rules = SH.ShardingRules(cfg, mesh, train=True)
    ps = fresh()
    pls = SH.place_params(ps, rules.param_specs(ps), mesh)
    os_ = init_adamw(ps)
    bs = SH.place_batch(batch, rules.data_specs(
        {k: tuple(v.shape) for k, v in batch.items()}), mesh)
    step = ST.make_train_step(cfg, shard=rules.shard_fn(), lr=LR,
                              grad_shardings=pls)
    with ta.CommDebugMode() as comm:
        ps, os_, m = step(ps, os_, bs)
    out["train_comm"] = _counts(comm.get_comm_counts())
    full = {n: p.full_tensor() for n, p in named_leaves(ps).items()}
    mu = {n: t.full_tensor() for n, t in os_.mu.items()}
    loss = m["loss"].full_tensor()
    out["placements_kept"] = all(
        tuple(p.placements) == pls[n] for n, p in named_leaves(ps).items())

    # ---- prefill and decode
    srules = SH.ShardingRules(cfg, mesh, train=False)
    pv = fresh()
    SH.place_params(pv, srules.param_specs(pv), mesh)
    cache = init_cache(cfg, B, S + DECODES, dtype=torch.float32,
                       device="cpu")
    cache = SH.place_cache(cache, srules.cache_specs(cache, B, False),
                           mesh, B)
    shard = srules.shard_fn()
    tok_pl = SH.placements(srules.data_specs({"t": (B, 1)})["t"], mesh)
    lg, cache = ST.make_prefill_step(cfg, shard=shard)(
        pv, cache, SH.place_batch({"tokens": tokens}, srules.data_specs(
            {"tokens": (B, S)}), mesh))
    stream = [ST.sample_greedy(lg.full_tensor(), cfg.vocab_size)]
    serve = ST.make_serve_step(cfg, shard=shard)
    for i in range(DECODES):
        t = ta.distribute(stream[-1], mesh, tok_pl)
        if i == 0:
            with ta.CommDebugMode() as comm:
                lg, cache = serve(pv, cache, t)
            out["decode_comm"] = _counts(comm.get_comm_counts())
        else:
            lg, cache = serve(pv, cache, t)
        stream.append(ST.sample_greedy(lg.full_tensor(), cfg.vocab_size))
    out["stream"] = torch.cat(stream, 1).tolist()
    out["full"], out["mu"], out["loss"] = full, mu, float(loss)
    return out


def _run_local(arch, mesh, rank, out):
    """What a rank does alone once every sharded step has run, so that
    the ranks do it at once: the dry-run's trace of the same steps on
    ``_tracer(arch)`` (meta tensors over the same mesh: it sends
    nothing), and the unsharded twins and the comparison on
    ``_checker(arch)``. Drops the full tensors ``out`` held for it."""
    from repro_torch.configs.shapes import InputShape
    from repro_torch.engine import steps as ST
    from repro_torch.engine.optim import init_adamw, named_leaves
    from repro_torch.launch.dryrun import measure_step
    from repro_torch.models.transformer import init_cache

    cfg, tokens, batch, fresh = _inputs(arch)
    full, mu, loss = out.pop("full"), out.pop("mu"), out.pop("loss")
    stream = out.pop("stream")
    if rank == _tracer(arch):
        for key, shape in (("train_dry", InputShape("t", S, B, "train")),
                           ("decode_dry", InputShape("d", S + DECODES, B,
                                                     "decode"))):
            fields, _ = measure_step(cfg, shape, mesh, torch.float32)
            out[key] = {k: v["n"] for k, v in
                        fields["collective_ops"].items()}
    if rank != _checker(arch):
        return out

    # ---- the unsharded twins, on the checking rank
    pu = fresh()
    ou = init_adamw(pu)
    pu, ou, mu_ = ST.make_train_step(cfg, lr=LR)(pu, ou, batch)
    out["loss"] = (float(loss), float(mu_["loss"]))
    big_err, small_err = [0.0], [0.0]
    for n, p in named_leaves(pu).items():
        err = (full[n] - p.detach()).abs()
        g = ou.mu[n].abs()
        big = g >= 1e-3 * g.max()
        big_err.append(float(err[big].max() / p.detach().abs().max())
                       if big.any() else 0.0)
        small_err.append(float(err[~big].max()) if (~big).any() else 0.0)
    out["param_err"] = (max(big_err), max(small_err))
    out["mu_err"] = max(float((mu[n] - g).abs().max()
                              / g.abs().max().clamp_min(1e-30))
                        for n, g in ou.mu.items())
    pv = fresh()
    cache = init_cache(cfg, B, S + DECODES, dtype=torch.float32,
                       device="cpu")
    lg, cache = ST.make_prefill_step(cfg)(pv, cache, {"tokens": tokens})
    want = [ST.sample_greedy(lg, cfg.vocab_size)]
    for _ in range(DECODES):
        lg, cache = ST.make_serve_step(cfg)(pv, cache, want[-1])
        want.append(ST.sample_greedy(lg, cfg.vocab_size))
    out["streams"] = (stream, torch.cat(want, 1).tolist())
    return out


def _rank_main(rank, store_path, q):
    import datetime

    import torch.distributed as dist

    from repro_torch.distributed import torch_api as ta
    try:
        torch.set_num_threads(1)      # four ranks share the host's cores
        store = dist.FileStore(store_path, WORLD)
        dist.init_process_group(
            "gloo", store=store, rank=rank, world_size=WORLD,
            timeout=datetime.timedelta(seconds=TIMEOUT_S))
        mesh = ta.init_device_mesh("cpu", (2, 2),
                                   mesh_dim_names=("data", "model"))
        res = {"t0": time.perf_counter()}
        for arch in ARCHS:
            res[arch] = _run_sharded(arch, mesh)
        for arch in ARCHS:
            res[arch] = _run_local(arch, mesh, rank, res[arch])
        res["seconds"] = time.perf_counter() - res.pop("t0")
        q.put((rank, res))
    except BaseException as e:           # noqa: BLE001 - sent to the test
        import traceback
        q.put((rank, {"error": f"{e!r}\n{traceback.format_exc()}"}))
    finally:
        ta.destroy_group()


@pytest.fixture(scope="module")
def ranks():
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        store = os.path.join(tmp, "store")
        procs = [ctx.Process(target=_rank_main, args=(r, store, q))
                 for r in range(WORLD)]
        for p in procs:
            p.start()
        got = {}
        deadline = time.monotonic() + TIMEOUT_S
        try:
            while len(got) < WORLD:
                left = deadline - time.monotonic()
                if left <= 0:
                    break
                try:
                    r, res = q.get(timeout=min(left, 5.0))
                except queue.Empty:
                    if any(p.exitcode not in (None, 0) for p in procs):
                        break
                    continue
                got[r] = res
        finally:
            for p in procs:
                p.join(5)
                if p.is_alive():
                    p.kill()
                    p.join()
    errors = {r: v["error"] for r, v in got.items() if "error" in v}
    assert not errors, errors
    assert len(got) == WORLD, f"ranks {sorted(set(range(WORLD)) - set(got))}"\
        " sent nothing before the timeout"
    return got


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_train_step_matches_unsharded(ranks, arch):
    r = ranks[_checker(arch)][arch]
    sharded, plain = r["loss"]
    assert abs(sharded - plain) <= 1e-6 * abs(plain), r["loss"]
    assert r["mu_err"] <= 1e-5, r["mu_err"]
    big, small = r["param_err"]
    assert big <= 1e-5, r["param_err"]
    assert small <= 2 * LR, r["param_err"]
    assert all(ranks[k][arch]["placements_kept"] for k in ranks)


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_prefill_decode_stream_greedy_tokens(ranks, arch):
    got, want = ranks[_checker(arch)][arch]["streams"]
    assert got == want


@pytest.mark.parametrize("arch", ARCHS)
def test_dryrun_collectives_equal_the_real_runs(ranks, arch):
    """The tracing rank's counts; every rank ran the same collectives
    (each is one call on all ranks)."""
    r = ranks[_tracer(arch)][arch]
    assert r["train_dry"] == r["train_comm"], r
    assert r["decode_dry"] == r["decode_comm"], r
    assert r["train_comm"], "the sharded train step ran no collective"
    for res in ranks.values():
        assert res[arch]["train_comm"] == r["train_comm"]
        assert res[arch]["decode_comm"] == r["decode_comm"]
