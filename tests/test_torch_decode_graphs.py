"""The decode sub-batch as its own pass: ``TorchEngine``'s CUDA-graph
path, on the CPU.

On the card, where ``graphs_engage`` holds, a step with decodes runs them
as a decode-only ``fused_serve_forward`` (``P = 0``) replayed from the CUDA
graph of their page-window rung, then its prefill rows as a prefill-only
one (``nd = 0``). Graphs are not captured on the CPU; the engine's
private ``_split`` switch runs the same two passes eagerly here. Contracts:

- one fused forward over both sub-batches samples the same ids and leaves
  the same pages or slot rows (all but the sink page or row, which both
  sub-batches' dropped writes share) as the decode-only call followed by
  the prefill-only call, in f32, in the paged and dense layouts, at every
  step of a run with admissions, releases and rung changes;
- the split engine streams what the fused engine streams, and counts its
  eager decode steps, with no graph captured or replayed;
- the decode pass's rung covers the decode rows alone;
- the engagement rule: the card, one rank, and no grouped-MoE layer;
- ``ops.tally`` / ``ops.add_tally``, which carry a captured pass's kernel
  counts onto each replay, and ``ops.recording``, which gathers one
  thread's counts while other threads launch.

``tests/test_torch_cuda.py`` holds the graphs themselves to eager passes
on the card.
"""
import threading
from collections import Counter

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.kvpool import blocks_for  # noqa: E402
from repro_torch.core.qos import QoSSpec  # noqa: E402
from repro_torch.core.request import Request  # noqa: E402
from repro_torch.core.scheduler import BatchPlan  # noqa: E402
from repro_torch.engine.torch_backend import (TorchEngine,  # noqa: E402
                                              graphs_engage)
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models.transformer import fused_serve_forward  # noqa: E402

QOS = QoSSpec("q", interactive=True, ttft_slo=1e6, tbt_slo=1e6)
# (arrival step, prompt tokens, output tokens): over 16-token pages the
# rows cross the rungs 1-4, 8 and 16 while others arrive and leave
SCRIPT = ((0, 20, 12), (0, 70, 20), (2, 130, 10), (5, 9, 25),
          (8, 200, 8), (12, 33, 30), (15, 90, 15), (20, 3, 20))
CHUNK = 48          # prefill tokens a request takes a step
BLOCK = 16


def tiny(arch: str = "llama3.2-3b", d_model: int = 128):
    return get_config(arch).reduced(num_layers=2, d_model=d_model)


def make(cfg, layout: str, device="cpu", **kw) -> TorchEngine:
    return TorchEngine(cfg, n_slots=4, max_len=256, quantum=16, seed=3,
                       kv_layout=layout, block_size=BLOCK, device=device,
                       **kw)


def drive(engine: TorchEngine, script=SCRIPT, chunk: int = CHUNK,
          max_steps: int = 400) -> int:
    """Serve ``script`` on ``engine`` with a plain first-come scheduler:
    each step admits the requests due that find a slot, prefills up to
    ``chunk`` tokens of each request still prefilling, decodes every
    other live request, and releases each request once its last token is
    out. Returns the steps executed."""
    reqs = [Request(rid=i, arrival=0.0, prompt_len=p, decode_len=d,
                    qos=QOS) for i, (_, p, d) in enumerate(script)]
    due = sorted(zip((a for a, _, _ in script), range(len(reqs))))
    live, steps = [], 0
    for t in range(max_steps):
        while due and due[0][0] <= t and engine.free_slots:
            r = reqs[due.pop(0)[1]]
            engine.on_admit(r)
            live.append(r)
        pre = [(r, min(chunk, r.prompt_len - r.prefilled)) for r in live
               if r.prefilled < r.prompt_len]
        dec = [r for r in live if r.prefilled == r.prompt_len]
        if not (pre or dec):
            if not due:
                break
            continue
        engine.execute(BatchPlan(prefill=pre, decode=dec), 0.0)
        steps += 1
        for r, c in pre:
            r.prefilled += c
        for r in list(live):
            if len(engine.generated[r.rid]) == r.decode_len:
                engine.on_release(r)
                live.remove(r)
    assert not due and not live, "the script did not finish"
    return steps


def _clone(cache: dict) -> dict:
    return {"layers": [type(c)(*(a.clone() for a in c))
                       for c in cache["layers"]]}


def assert_same_cache(a: dict, b: dict) -> None:
    """Every field of every layer equal bit for bit, but the sink page or
    row (the last), where both sub-batches drop their writes."""
    for li, (x, y) in enumerate(zip(a["layers"], b["layers"])):
        for name, u, v in zip(x._fields, x, y):
            assert torch.equal(u[:-1], v[:-1]), (li, name)


def _split_forward(eng, cache, rows, bts_host) -> torch.Tensor:
    """The decode-only call, then the prefill-only call, on ``cache``:
    the sampled ids, prefill rows then decode slots."""
    pre, dec = [torch.from_numpy(a) for a in rows[:6]], \
        [torch.from_numpy(a) for a in rows[6:]]
    pre_bt, dec_bt = (None if b is None else torch.from_numpy(b)
                      for b in bts_host)
    P, nd = pre[0].shape[0], dec[0].shape[0]
    ids = []
    if nd:
        ids.append(fused_serve_forward(
            eng.params, eng.cfg, cache, *(a[:0] for a in pre), *dec,
            None if pre_bt is None else pre_bt[:0], dec_bt, eng.moe_impl))
    if P:
        ids.insert(0, fused_serve_forward(
            eng.params, eng.cfg, cache, *pre, *(a[:0] for a in dec),
            pre_bt, None if dec_bt is None else dec_bt[:0], eng.moe_impl))
    return torch.cat(ids)


@pytest.mark.parametrize("layout", ["paged", "dense"])
def test_decode_then_prefill_pass_equals_fused(layout, monkeypatch):
    """At every step of a run, the fused forward's ids and cache against
    the decode-only and prefill-only calls on a copy of the cache."""
    eng = make(tiny(), layout)
    assert not eng._split
    inner = eng._step
    shapes = Counter()

    def step(rows, bts_host, bts=None):
        split = _clone(eng.cache)
        want = _split_forward(eng, split, rows, bts_host)
        got = inner(rows, bts_host, bts)
        assert torch.equal(got, want)
        assert_same_cache(eng.cache, split)
        shapes[len(rows[0]) > 0, len(rows[6]) > 0] += 1
        return got
    monkeypatch.setattr(eng, "_step", step)
    steps = drive(eng)
    assert sum(shapes.values()) == steps >= 40
    # prefill-only, mixed and decode-only steps all occurred
    assert set(shapes) == {(True, False), (True, True), (False, True)}
    if layout == "paged":
        assert len(eng.gather_bucket_hits) >= 4, eng.gather_bucket_hits


@pytest.mark.parametrize("layout", ["paged", "dense"])
def test_split_engine_streams_what_the_fused_engine_streams(layout):
    """The engine's own split path (eager passes over the static decode
    inputs) against its fused path: equal streams, the same decode steps
    counted as eager, nothing captured or replayed."""
    cfg = tiny()
    fused, split = make(cfg, layout), make(cfg, layout)
    split._split = True
    n = drive(fused)
    assert drive(split) == n
    assert split.generated == fused.generated
    decode_steps = sum(1 for cost, _ in fused.iteration_log
                       if len(cost.decode_ctxs))
    assert split.eager_decode_steps == fused.eager_decode_steps \
        == decode_steps > 0
    assert split.graph_replays == split.graph_captures == 0
    assert split.jit_compiles == fused.jit_compiles == 0
    assert split.buckets_seen == fused.buckets_seen


def test_decode_rung_covers_the_decode_rows_alone():
    """A short decode row beside a long prefill chunk: the decode pass
    reads the rung of its own rows, the prefill rows the rung of all."""
    eng = make(tiny(), "paged")
    eng._split = True
    rungs = []
    inner = eng._stage_decode

    def stage(dec_active, maxb):
        need = max(blocks_for(int(eng.slot_len[s]) + 1, BLOCK)
                   for s in np.flatnonzero(dec_active))
        rungs.append((maxb, eng._maxb_bucket(need),
                      eng._pre_bt_host.shape[1]))
        return inner(dec_active, maxb)
    eng._stage_decode = stage
    short = Request(rid=0, arrival=0.0, prompt_len=20, decode_len=9, qos=QOS)
    long = Request(rid=1, arrival=0.0, prompt_len=200, decode_len=2,
                   qos=QOS)
    eng.on_admit(short)
    eng.execute(BatchPlan(prefill=[(short, 20)]), 0.0)
    short.prefilled = 20
    eng.on_admit(long)
    for start in range(0, 200, 64):
        c = min(64, 200 - start)
        eng.execute(BatchPlan(prefill=[(long, c)], decode=[short]), 0.0)
        long.prefilled += c
    eng.execute(BatchPlan(decode=[short, long]), 0.0)
    assert [m for m, _, _ in rungs] == [w for _, w, _ in rungs]
    # blocks of 16: the short row needs 2 blocks (rung 2); the prefill
    # chunks reach 64, 128, 192 and 200 tokens (rungs 4, 8, 16, 16)
    assert [(m, p) for m, _, p in rungs] == [(2, 4), (2, 8), (2, 16),
                                             (2, 16), (16, 16)]
    assert eng.gather_bucket_hits == {2: 1, 4: 1, 8: 1, 16: 3}


@pytest.mark.parametrize("arch,moe_impl,engage", [
    ("llama3.2-3b", "grouped", True),
    ("gemma3-4b", "grouped", True),             # sliding-window layers
    ("mamba2-370m", "grouped", True),
    ("qwen3-moe-30b-a3b", "grouped", False),    # reads its segment size
    ("qwen3-moe-30b-a3b", "dropless", True),
    ("jamba-v0.1-52b", "grouped", False),
    ("jamba-v0.1-52b", "dropless", True),
])
@pytest.mark.parametrize("where", ["cuda", "cuda tp 2", "cpu"])
def test_graphs_engage_by_layer_type_rank_and_device(arch, moe_impl, engage,
                                                     where):
    cfg = get_config(arch)
    device = torch.device(where.split()[0])
    tp = 2 if "tp" in where else 1
    assert graphs_engage(cfg, device, tp, moe_impl) \
        == (engage and where == "cuda")


def test_cpu_engine_runs_the_fused_path():
    eng = make(tiny(), "paged")
    assert not eng._split and not eng._capture
    drive(eng)
    assert eng.jit_compiles == eng.graph_captures == eng.graph_replays == 0
    assert eng.eager_decode_steps > 0


def test_tally_differences_add_back():
    """A difference of two ``tally()`` readings, added ``times`` over,
    moves ``counts()``, ``variants()`` and ``heads()`` by that much; a
    count added back to zero leaves no key."""
    x = torch.randn(3, 64)
    before = ops.tally()
    ops.rmsnorm(x, torch.zeros(64))
    d = ops.tally() - before
    assert d == Counter({("plain", "rmsnorm"): 1})
    ops.add_tally(d, 2)
    assert ops.counts()["rmsnorm"]["plain"] \
        == before["plain", "rmsnorm"] + 3
    v = Counter({("variants", "paged_attention", (64, 16)): 2,
                 ("heads", "paged_attention", (8, 2)): 2,
                 ("launches", "paged_attention"): 1})
    launched = ops.counts()["paged_attention"]["launches"]
    ops.add_tally(v)
    assert ops.variants()["paged_attention"][64, 16] >= 2
    assert ops.heads()["paged_attention"][8, 2] >= 2
    assert ops.counts()["paged_attention"]["launches"] == launched + 1
    ops.add_tally(v, -1)
    ops.add_tally(d, -3)
    assert ops.tally() == before


@pytest.mark.parametrize("nested", [False, True])
def test_recording_gathers_this_threads_counts_alone(nested):
    """Calls made on another thread while a recording is open (as another
    engine launches while one captures) move the counts but stay out of
    the recording; an inner recording leaves the outer one's holds to it
    and the outer one resumes after."""
    x, w = torch.randn(3, 64), torch.zeros(64)
    stop, started = threading.Event(), threading.Event()
    others = []

    def other():
        started.set()
        while not stop.is_set():
            ops.rmsnorm(x, w)
            others.append(1)
    t = threading.Thread(target=other)
    before = ops.tally()
    t.start()
    started.wait()
    try:
        with ops.recording() as mine:
            for _ in range(50):
                ops.rmsnorm(x, w)
            if nested:
                with ops.recording() as inner:
                    ops.rmsnorm(x, w)
                assert inner == Counter({("plain", "rmsnorm"): 1})
            ops.chunked_prefill_attention(torch.randn(1, 4, 2, 64),
                                          torch.randn(1, 4, 2, 64),
                                          torch.randn(1, 4, 2, 64))
    finally:
        stop.set()
        t.join()
    assert others
    assert mine == Counter({("plain", "rmsnorm"): 50,
                            ("plain", "chunked_prefill_attention"): 1})
    assert ops.tally() - before == Counter(
        {("plain", "rmsnorm"): 50 + nested + len(others),
         ("plain", "chunked_prefill_attention"): 1})
