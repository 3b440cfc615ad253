"""The page-window (``maxb``) axis of ``TorchEngine``'s shape buckets:
the twins of tests/test_paged_buckets.py for the port.

The paged engine slices its per-iteration block tables to the smallest
ladder width covering the longest live row (exact rungs up to 4 blocks,
pow-2 beyond). Contracts:

- the chosen bucket is MINIMAL-COVERING for every live length, including
  block-boundary straddles (len == k*bs and k*bs + 1), and the ladder is
  ``JaxEngine``'s for the same geometry;
- ``gather_buckets=False`` pins every table to the full window;
- mid-decode bucket transitions stream what the full-window gather and
  the reference engine stream. The dropped trailing table columns hold
  only positions past every row's query. On the CPU the plain attention
  versions reduce over the key axis in blocks that depend on its length,
  so the sampled hidden states of the two windows agree within 2e-6 (f32;
  up to 1.65e-6 measured), not bit for bit; JAX's own test asserts the
  streams only;
- ``warm()`` returns its call count and ``jit_compiles <=
  len(buckets_seen)`` holds before and after serving (0 compiled
  programs: the engine runs eagerly).
"""
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.engine.jax_backend import JaxEngine  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.kvpool import blocks_for  # noqa: E402
from repro_torch.core.qos import QoSSpec  # noqa: E402
from repro_torch.core.request import Request  # noqa: E402
from repro_torch.core.scheduler import BatchPlan  # noqa: E402
from repro_torch.engine.torch_backend import (ReferenceTorchEngine,  # noqa
                                              TorchEngine)
from repro_torch.models import transformer as TT  # noqa: E402

QOS = QoSSpec("q", interactive=True, ttft_slo=1e6, tbt_slo=1e6)
# sampled hidden states, bucketed against full window (f32 on the CPU)
HIDDEN_TOL = 2e-6


def reduced(arch):
    return get_config(arch).reduced(num_layers=2, d_model=128)


def test_maxb_bucket_minimal_covering_sweep():
    """Deterministic sweep over every live length 1..max_len: the chosen
    maxb covers the length AND no smaller ladder rung does — including
    the block-boundary straddles where need jumps by one block."""
    cfg = reduced("llama3.2-3b")
    eng = TorchEngine(cfg, n_slots=2, max_len=256, quantum=16, seed=0,
                      kv_layout="paged", block_size=32, device="cpu")
    bs, mb = eng.block_size, eng.max_blocks
    ladder = eng._maxb_ladder()
    # dense head, geometric tail: exact widths up to 4, pow-2 beyond
    assert set(range(1, min(4, mb) + 1)) <= set(ladder)
    assert ladder[-1] == mb and ladder == sorted(set(ladder))
    for length in range(1, eng.max_len + 1):
        need = blocks_for(length, bs)
        maxb = eng._maxb_bucket(need)
        assert maxb * bs >= length, (length, maxb)        # covering
        assert maxb in ladder, (length, maxb)             # a ladder rung
        smaller = [r for r in ladder if r < maxb]
        assert all(r < need for r in smaller), \
            f"len {length}: maxb {maxb} not minimal (need {need})"
        if need <= 4:                                     # dense head
            assert maxb == need, (length, maxb)
    # boundary straddles explicitly: k*bs fits in the k-block rung,
    # k*bs + 1 must escalate past it
    for k in range(1, mb):
        at = eng._maxb_bucket(blocks_for(k * bs, bs))
        over = eng._maxb_bucket(blocks_for(k * bs + 1, bs))
        assert at * bs >= k * bs
        assert over > k - 1 and over * bs >= k * bs + 1
        assert over >= at


@pytest.mark.parametrize("max_len,block_size,gather",
                         [(256, 32, True), (128, 32, True), (2048, 64, True),
                          (4096, 16, True), (128, 32, False),
                          (2048, 64, False)])
def test_maxb_ladder_equals_jax(max_len, block_size, gather):
    """The same geometry gives ``JaxEngine``'s ladder, and the same
    bucket for every need."""
    jc = jax_get_config("llama3.2-3b").reduced(num_layers=2, d_model=128)
    tc = reduced("llama3.2-3b")
    kw = dict(n_slots=2, max_len=max_len, quantum=16, seed=0,
              kv_layout="paged", block_size=block_size,
              gather_buckets=gather)
    jeng = JaxEngine(jc, **kw)
    teng = TorchEngine(tc, device="cpu", **kw)
    assert teng._maxb_ladder() == jeng._maxb_ladder()
    assert [teng._maxb_bucket(n) for n in range(1, teng.max_blocks + 1)] \
        == [jeng._maxb_bucket(n) for n in range(1, jeng.max_blocks + 1)]


def test_bucketed_gather_disabled_pins_full_window():
    cfg = reduced("llama3.2-3b")
    eng = TorchEngine(cfg, n_slots=2, max_len=128, quantum=16, seed=0,
                      kv_layout="paged", block_size=32, gather_buckets=False,
                      device="cpu")
    assert eng._maxb_bucket(1) == eng.max_blocks
    assert eng._maxb_bucket(eng.max_blocks) == eng.max_blocks
    assert eng._maxb_ladder() == [eng.max_blocks]


def _drive_boundary_decode(engine, mid=None):
    """Prompt 30 at block_size 32: decoding crosses the 32-token block
    boundary mid-stream, forcing a maxb 1 -> 2 bucket transition; a second
    request keeps a mixed batch live across the transition. ``mid`` is
    called after the first iteration."""
    r0 = Request(rid=0, arrival=0.0, prompt_len=30, decode_len=9, qos=QOS)
    r1 = Request(rid=1, arrival=0.0, prompt_len=45, decode_len=7, qos=QOS)
    engine.on_admit(r0)
    engine.execute(BatchPlan(prefill=[(r0, 30)]), 0.0)
    r0.prefilled = 30
    if mid is not None:
        mid()
    engine.on_admit(r1)
    engine.execute(BatchPlan(prefill=[(r1, 45)], decode=[r0]), 0.0)
    r1.prefilled = 45
    for _ in range(6):
        engine.execute(BatchPlan(decode=[r0, r1]), 0.0)
    engine.execute(BatchPlan(decode=[r0]), 0.0)
    engine.on_release(r0)
    engine.on_release(r1)
    # each request's final prefill chunk emits its first token, then one
    # per decode execute: r0 = 1 + 8, r1 = 1 + 6
    return {0: 9, 1: 7}


def _recording_hidden(monkeypatch):
    """Record every fused iteration's sampled hidden rows."""
    seen = []
    inner = TT._sampled_hidden

    def rec(*args, **kw):
        out = inner(*args, **kw)
        seen.append(out.detach().clone())
        return out
    monkeypatch.setattr(TT, "_sampled_hidden", rec)
    return seen


@pytest.mark.parametrize("arch", ["llama3.2-3b", "qwen3-moe-30b-a3b"])
def test_bucket_transition_matches_full_window(arch, monkeypatch):
    """The same plan sequence through a bucketed-gather engine, a
    full-window engine, and the reference oracle: all three streams must
    be equal through the mid-decode maxb transition, and the two fused
    engines' sampled hidden states agree within ``HIDDEN_TOL``."""
    cfg = reduced(arch)
    kw = dict(n_slots=2, max_len=128, quantum=16, seed=7,
              kv_layout="paged", block_size=32, device="cpu")
    bucketed = TorchEngine(cfg, **kw)
    full = TorchEngine(cfg, gather_buckets=False, **kw)
    ref = ReferenceTorchEngine(cfg, n_slots=2, max_len=128, quantum=1,
                               seed=7, device="cpu")
    want = _drive_boundary_decode(ref)
    seen = _recording_hidden(monkeypatch)
    _drive_boundary_decode(bucketed)
    hid_b = list(seen)
    seen.clear()
    _drive_boundary_decode(full)
    hid_f = list(seen)
    for rid, n in want.items():
        assert len(ref.generated[rid]) == n
        assert bucketed.generated[rid] == ref.generated[rid], \
            f"{arch} rid {rid}: bucketed gather diverged"
        assert full.generated[rid] == ref.generated[rid], \
            f"{arch} rid {rid}: full-window gather diverged"
    assert len(hid_b) == len(hid_f) == 9
    for i, (a, b) in enumerate(zip(hid_b, hid_f)):
        assert a.shape == b.shape
        err = float((a - b).abs().max())
        assert err <= HIDDEN_TOL, (arch, i, err)
    # the bucketed engine really served through multiple page windows
    assert len(bucketed.gather_bucket_hits) >= 2, \
        bucketed.gather_bucket_hits
    assert set(full.gather_bucket_hits) == {full.max_blocks}
    # bucket keys carry the maxb axis
    assert all(len(b) == 4 for b in bucketed.buckets_seen)
    assert {b[3] for b in full.buckets_seen} == {full.max_blocks}


def test_warm_returns_its_calls_and_bounds_compiles():
    """``warm(max_chunk)`` takes JAX's signature and returns the calls it
    made; the eager engine compiles no program, so ``jit_compiles`` stays
    0 <= ``len(buckets_seen)`` through serving, and every bucket served
    sits on the ladder, as JAX's warmed lattice would."""
    cfg = reduced("llama3.2-3b")
    eng = TorchEngine(cfg, n_slots=2, max_len=128, quantum=16, seed=7,
                      kv_layout="paged", block_size=32, device="cpu")
    assert eng.warm(64) == 1
    assert eng.warm() == 1
    assert eng._maxb_ladder() == [1, 2, 3, 4]    # max_blocks = 4 here
    assert eng.jit_compiles == 0 <= len(eng.buckets_seen)
    _drive_boundary_decode(eng)
    assert eng.jit_compiles == 0
    assert eng.jit_compiles <= len(eng.buckets_seen)
    assert {b[3] for b in eng.buckets_seen} <= set(eng._maxb_ladder())
    ref = ReferenceTorchEngine(cfg, n_slots=2, max_len=128, quantum=1,
                               seed=7, device="cpu")
    assert ref.warm(64) == 2 and ref.warm() == 2
    assert ref.jit_compiles == 0
    assert not hasattr(ref, "_swap_store")   # scrape's _engine_of skips it


def test_warm_moves_no_live_state():
    """A warm-up between two iterations of a live request leaves the
    streams as they are without it (its writes go to the sink page)."""
    cfg = reduced("llama3.2-3b")
    kw = dict(n_slots=2, max_len=128, quantum=16, seed=7,
              kv_layout="paged", block_size=32, device="cpu")
    a, b = TorchEngine(cfg, **kw), TorchEngine(cfg, **kw)
    _drive_boundary_decode(a, mid=lambda: a.warm(64))
    _drive_boundary_decode(b)
    assert a.generated == b.generated
