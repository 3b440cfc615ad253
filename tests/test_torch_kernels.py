"""The port's plain kernel versions against the JAX package: the
oracles of ``repro/kernels/ref.py``, the Pallas kernels in interpret
mode and, for the SSD scan, ``models/mamba2.py::ssd_chunked`` (what JAX
serving runs), on the sweeps of tests/test_kernels.py plus the engine's
edge cases. Inputs are drawn with numpy and handed to both frameworks.

Tolerances: 2e-5 in f32 (summation order only), 2e-2 in bf16 (one bf16
rounding of the output), as tests/test_kernels.py states them; the SSD
scan's are stated at its tests.

The CUDA kernels themselves run only on the card; ``chip_smoke.py``
holds them against these plain versions there. Here the dispatch is
checked: a CPU tensor reaches the plain version and launches nothing.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import mamba2 as jmamba  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels.chunked_prefill_attention import \
    chunked_prefill_attention_cuda  # noqa: E402
from repro_torch.kernels.paged_attention import \
    paged_attention_cuda  # noqa: E402

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"f32": 2e-5, "bf16": 2e-2}


def _both(x: np.ndarray, dt: str):
    jd, td = DTYPES[dt]
    return jnp.asarray(x).astype(jd), torch.from_numpy(x).to(td)


def _close(got_t, want_j, dt):
    np.testing.assert_allclose(got_t.float().numpy(),
                               np.asarray(want_j, np.float32),
                               atol=TOL[dt], rtol=TOL[dt])


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize(
    "B,C,H,KV,D,S,q_off,kv_len,window",
    [
        (1, 64, 4, 4, 64, 256, 0, 64, None),      # MHA, no prefix
        (2, 128, 8, 2, 64, 512, 200, 328, None),  # GQA mid-cache
        (1, 256, 4, 1, 128, 256, 0, 256, None),   # MQA full
        (2, 64, 8, 4, 64, 512, 313, 377, None),   # unaligned kv_len
        (1, 128, 4, 2, 64, 512, 128, 256, 100),   # sliding window
        (1, 128, 4, 2, 64, 512, 384, 512, 64),    # window < block
    ])
def test_chunked_prefill_static_vs_jax(dt, B, C, H, KV, D, S, q_off,
                                           kv_len, window):
    rng = np.random.default_rng(0)
    qj, qt = _both(rng.standard_normal((B, C, H, D), np.float32), dt)
    kj, kt = _both(rng.standard_normal((B, S, KV, D), np.float32), dt)
    vj, vt = _both(rng.standard_normal((B, S, KV, D), np.float32), dt)
    got = tops.chunked_prefill_attention(qt, kt, vt, q_offset=q_off,
                                         kv_len=kv_len, window=window)
    want = jref.chunked_prefill_attention_ref(qj, kj, vj, q_off, kv_len,
                                              window=window)
    _close(got, want, dt)
    if dt == "f32":
        _close(got, jops.chunked_prefill_attention(
            qj, kj, vj, q_offset=q_off, kv_len=kv_len, window=window,
            interpret=True), dt)


@pytest.mark.parametrize("window", [None, 40])
def test_chunked_prefill_dynamic_rows_vs_pallas(window):
    """Per-row offsets (the engine's layout) against the Pallas kernel's
    dynamic mode in interpret mode, with a ragged C (not a multiple of
    any block) and a pad row (kv_len 0), which must give zeros."""
    B, C, H, KV, D, S = 4, 32, 6, 2, 32, 128
    rng = np.random.default_rng(1)
    q = rng.standard_normal((B, C, H, D), np.float32)
    k = rng.standard_normal((B, S, KV, D), np.float32)
    v = rng.standard_normal((B, S, KV, D), np.float32)
    qoffs = np.array([0, 17, 96, 0], np.int32)
    lens = np.array([32, 49, 128, 0], np.int32)
    got = tops.chunked_prefill_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        q_offsets=torch.from_numpy(qoffs), kv_lens=torch.from_numpy(lens),
        window=window)
    want = jops.chunked_prefill_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), q_offset=0,
        kv_len=S, window=window, q_offsets=jnp.asarray(qoffs),
        kv_lens=jnp.asarray(lens), block_q=32, block_k=64, interpret=True)
    _close(got, want, "f32")
    assert (got[3] == 0).all()
    for b in range(3):   # and row by row against the static oracle
        want_b = jref.chunked_prefill_attention_ref(
            jnp.asarray(q[b:b + 1]), jnp.asarray(k[b:b + 1]),
            jnp.asarray(v[b:b + 1]), int(qoffs[b]), int(lens[b]),
            window=window)
        _close(got[b:b + 1], want_b, "f32")


def _paged_inputs(rng, B, H, KV, D, P, page, pages, lens, holes=()):
    q = rng.standard_normal((B, H, D), np.float32)
    kp = rng.standard_normal((P, page, KV, D), np.float32)
    vp = rng.standard_normal((P, page, KV, D), np.float32)
    bt = np.full((B, pages), -1, np.int32)
    for b in range(B):
        n = -(-lens[b] // page)
        bt[b, :n] = rng.choice(P, size=n, replace=False)
    for b, pi in holes:
        bt[b, pi] = -1
    return q, kp, vp, bt, np.asarray(lens, np.int32)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("B,H,KV,D,P,page,pages,lens,holes", [
    (2, 8, 4, 64, 16, 64, 4, (190, 100), ()),
    (1, 4, 1, 128, 8, 128, 3, (301,), ()),
    (3, 4, 4, 64, 12, 32, 4, (128, 1, 97), ()),
    # the engine's edge cases: G = 3 (the 24:8 ratio), a -1 hole in the
    # middle of a table, lens not a multiple of the page, and a fully
    # masked row (an inactive decode slot: all -1 with a positive len)
    (3, 6, 2, 32, 20, 16, 6, (83, 40, 57), ((0, 2), (2, 0), (2, 1),
                                            (2, 2), (2, 3))),
])
def test_paged_attention_vs_jax(dt, B, H, KV, D, P, page, pages, lens,
                                holes):
    rng = np.random.default_rng(2)
    q, kp, vp, bt, ln = _paged_inputs(rng, B, H, KV, D, P, page, pages,
                                      lens, holes)
    qj, qt = _both(q, dt)
    kj, kt = _both(kp, dt)
    vj, vt = _both(vp, dt)
    got = tops.paged_attention(qt, kt, vt, torch.from_numpy(bt),
                               torch.from_numpy(ln))
    args = (qj, kj, vj, jnp.asarray(bt), jnp.asarray(ln))
    _close(got, jref.paged_attention_ref(*args), dt)
    if dt == "f32":
        _close(got, jops.paged_attention(*args, interpret=True), dt)
    for b in range(B):
        if (bt[b] < 0).all():
            assert (got[b] == 0).all()


def test_cpu_tensors_take_the_plain_path():
    """Dispatch is by device: CPU tensors reach the plain versions and
    launch no kernel; the CUDA wrappers refuse CPU tensors outright."""
    from repro_torch.kernels import chunked_prefill_attention as cpa
    from repro_torch.kernels import paged_attention as pa
    rng = np.random.default_rng(3)
    q, kp, vp, bt, ln = (torch.from_numpy(a) for a in _paged_inputs(
        rng, 2, 4, 2, 64, 8, 16, 3, (30, 9)))
    qc = torch.from_numpy(rng.standard_normal((2, 16, 4, 64), np.float32))
    kc = torch.from_numpy(rng.standard_normal((2, 48, 2, 64), np.float32))
    offs = torch.tensor([0, 5], dtype=torch.int32)
    lens = torch.tensor([16, 21], dtype=torch.int32)
    tops.reset_counts()
    out = tops.paged_attention(q, kp, vp, bt, ln)
    assert torch.equal(out, tref.paged_attention_ref(q, kp, vp, bt, ln))
    tops.chunked_prefill_attention(qc, kc, kc, q_offsets=offs, kv_lens=lens)
    with tops.plain_versions():
        tops.chunked_prefill_attention(qc, kc, kc, q_offset=3, kv_len=40)
    assert tops.counts() == {
        "paged_attention": {"launches": 0, "plain": 1},
        "paged_attention_int8": {"launches": 0, "plain": 0},
        "chunked_prefill_attention": {"launches": 0, "plain": 2},
        "rmsnorm": {"launches": 0, "plain": 0},
        "rmsnorm_bwd": {"launches": 0, "plain": 0},
        "ssd_scan": {"launches": 0, "plain": 0},
        "ssd_scan_bwd": {"launches": 0, "plain": 0}}
    assert pa.launches == 0 and cpa.launches == 0
    with pytest.raises(ValueError, match="CUDA"):
        paged_attention_cuda(q, kp, vp, bt, ln)
    with pytest.raises(ValueError, match="CUDA"):
        chunked_prefill_attention_cuda(qc, kc, kc, offs, lens)
    tops.reset_counts()


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("N,D,block", [(256, 128, 64), (512, 1024, 256),
                                       (8, 3072, 8), (6, 77, 3)])
def test_rmsnorm_plain_vs_jax(dt, N, D, block):
    """The plain norm against the JAX oracle and, in f32, the Pallas
    kernel in interpret mode (``block`` rows a grid step, dividing N);
    D = 77 is a width the CUDA kernel reads element by element."""
    rng = np.random.default_rng(4)
    xj, xt = _both(rng.standard_normal((N, D), np.float32), dt)
    wj, wt = _both(rng.standard_normal((D,), np.float32) * 0.1, dt)
    got = tops.rmsnorm(xt, wt)
    assert got.dtype == xt.dtype and got.shape == (N, D)
    _close(got, jref.rmsnorm_ref(xj, wj), dt)
    if dt == "f32":
        _close(got, jops.rmsnorm(xj, wj, block_rows=block, interpret=True),
               dt)


def _ssd_inputs(rng, B, S, nh, hd, ds, zero_tail=0):
    """As tests/test_kernels.py draws them: x * 0.5, B, C * 0.3, softplus
    dt, A = -exp(0.3 z), a small carried state."""
    x = rng.standard_normal((B, S, nh, hd), np.float32) * 0.5
    dt = np.log1p(np.exp(rng.standard_normal((B, S, nh)))).astype(
        np.float32)
    if zero_tail:
        dt[:, S - zero_tail:] = 0.0
    A = -np.exp(rng.standard_normal((nh,)) * 0.3).astype(np.float32)
    Bm = rng.standard_normal((B, S, ds), np.float32) * 0.3
    Cm = rng.standard_normal((B, S, ds), np.float32) * 0.3
    h0 = rng.standard_normal((B, nh, hd, ds), np.float32) * 0.1
    return x, dt, A, Bm, Cm, h0


def _close_scaled(got, want, rel):
    """Every element within ``rel`` of ``want``'s largest magnitude."""
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=rel * float(np.abs(want).max()))


@pytest.mark.parametrize("B,S,nh,hd,ds,chunk,zero_tail", [
    (2, 128, 4, 32, 16, 32, 0),
    (1, 256, 2, 64, 128, 64, 0),
    (2, 64, 8, 16, 32, 64, 0),      # a single chunk
    (2, 75, 8, 32, 32, 32, 0),      # ragged: padded to the chunk grid
    (1, 100, 4, 32, 32, 32, 30),    # a zero-dt tail, as masked pad tokens
])
def test_ssd_scan_plain_vs_jax(B, S, nh, hd, ds, chunk, zero_tail):
    """The plain scan against ``ssd_chunked`` (any S: both pad to the
    chunk grid) and, where S is a multiple of the chunk, against the
    Pallas kernel in interpret mode, within 1e-5 of the output's largest
    magnitude in f32 (summation order); against the token-at-a-time
    oracle within 1e-4 of it (another order of the same sums). A zero-dt
    tail leaves the state where the cut rows leave it."""
    rng = np.random.default_rng(5)
    arrs = _ssd_inputs(rng, B, S, nh, hd, ds, zero_tail)
    j = [jnp.asarray(a) for a in arrs]
    y, h = tops.ssd_scan(*(torch.from_numpy(a) for a in arrs), chunk=chunk)
    assert y.shape == (B, S, nh, hd) and y.dtype == torch.float32
    assert h.shape == (B, nh, hd, ds) and h.dtype == torch.float32
    yj, hj = jmamba.ssd_chunked(*j, chunk)
    _close_scaled(y, yj, 1e-5)
    _close_scaled(h, hj, 1e-5)
    if S % chunk == 0:
        yp, hp = jops.ssd_scan(*j, chunk=chunk, interpret=True)
        _close_scaled(y, yp, 1e-5)
        _close_scaled(h, hp, 1e-5)
    yo, ho = jref.ssd_scan_ref(*j)
    _close_scaled(y, yo, 1e-4)
    _close_scaled(h, ho, 1e-4)
    if zero_tail:
        cut = [torch.from_numpy(a[:, :S - zero_tail].copy()) if a.ndim > 1
               and a.shape[1] == S else torch.from_numpy(a) for a in arrs]
        _, h_cut = tops.ssd_scan(*cut, chunk=chunk)
        _close_scaled(h, h_cut.numpy(), 1e-6)


def test_ssd_scan_bf16_inputs_compute_in_f32():
    """x, B and C in bf16 give the f32 result of their bf16 values, as
    ``ssd_chunked`` casts them: the same scan on the upcast inputs."""
    rng = np.random.default_rng(6)
    x, dt, A, Bm, Cm, h0 = (torch.from_numpy(a) for a in _ssd_inputs(
        rng, 2, 96, 4, 32, 32))
    xb, Bb, Cb = (t.to(torch.bfloat16) for t in (x, Bm, Cm))
    y, h = tops.ssd_scan(xb, dt, A, Bb, Cb, h0, chunk=32)
    y32, h32 = tops.ssd_scan(xb.float(), dt, A, Bb.float(), Cb.float(), h0,
                             chunk=32)
    assert y.dtype == torch.float32
    assert torch.equal(y, y32) and torch.equal(h, h32)


def test_cpu_tensors_take_the_plain_norm_and_scan():
    """The norm and the scan dispatch by device as attention does: CPU
    tensors reach the plain versions and launch nothing; the CUDA
    wrappers refuse CPU tensors outright."""
    from repro_torch.kernels import rmsnorm as rms
    from repro_torch.kernels import ssd_scan as ssd
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.standard_normal((2, 5, 64), np.float32))
    w = torch.zeros(64)
    args = [torch.from_numpy(a) for a in _ssd_inputs(rng, 1, 64, 2, 16, 64)]
    tops.reset_counts()
    out = tops.rmsnorm(x, w, 1e-5)
    assert out.shape == x.shape
    assert torch.equal(out, tref.rmsnorm_ref(x, w, 1e-5))
    tops.ssd_scan(*args, chunk=64)
    assert tops.counts()["rmsnorm"] == {"launches": 0, "plain": 1}
    assert tops.counts()["ssd_scan"] == {"launches": 0, "plain": 1}
    assert rms.launches == 0 and ssd.launches == 0
    with pytest.raises(ValueError, match="CUDA"):
        rms.rmsnorm_cuda(x[0], w)
    with pytest.raises(ValueError, match="CUDA"):
        ssd.ssd_scan_cuda(*args, 64)
    tops.reset_counts()
