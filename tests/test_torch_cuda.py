"""The port's CUDA kernels against their plain PyTorch versions, on the
card: the engine's edge cases at small shapes (G = 3, -1 holes mid-table,
lens not a multiple of the page, fully masked rows, ragged chunks, pad
rows, windows; decode with one row, with a 4096-token row over 32
splits and with splits whose pages are all holes; int8 pages with G = 1
and G = 8, D = 64 and pages that are not a multiple of the 32-token
tile; prefill chunks of 1, 65 and 1024 tokens; head_dim 256 in both
attention kernels (gemma3-4b: decode in both page types, chunks past
a 1024-token window, windowed C = 1 rows); norm rows that are not a
multiple of 16 bytes wide; scan lengths off the chunk grid, read in place
down to one token, zero-dt tails and d_state 16), the bit-equality of
the kernels' rows (attention: a row alone against the same row in a
batch, a narrower block table or cache view against a wider one, a
shorter chunk against a longer one; the scan and the norm: a row alone
against the same row in a batch) and the wrappers' refusals. ``chip_smoke.py`` checks the same kernels at the main paths'
shapes.

On a machine with an NVIDIA GPU and nvcc:

  PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Elsewhere every test here skips. Tolerances, element by element as
``atol + rtol * |plain|``: 1e-4 in f32 (summation order; TF32 is off);
in bf16 one bf16 ulp of the output (rtol 2^-7, atol 1e-5), since kernel
and plain version both accumulate in fp32 and round the output once.
The norm in f32 is held to 8 ulps (rtol 2^-20, atol 1e-6), and the scan,
whose output is fp32 in either input dtype, to 5e-4 of its output's
largest magnitude (the versions sum the chunk's cumulative decay in
different orders; ``chip_smoke.py``'s ``SSD_REL``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops, ref  # noqa: E402

pytestmark = pytest.mark.cuda

DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
TOL = {"f32": dict(atol=1e-4, rtol=1e-4),
       "bf16": dict(atol=1e-5, rtol=2 ** -7)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _t(a, dev, dtype=None):
    t = torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    return t if dtype is None else t.to(dtype)


def _paged(rng, dev, dtype, B, H, KV, D, P, page, pages, lens, holes):
    bt = np.full((B, pages), -1, np.int32)
    for b in range(B):
        n = -(-lens[b] // page)
        bt[b, :n] = rng.choice(P, size=n, replace=False)
    for b, pi in holes:
        bt[b, pi] = -1
    return (_t(rng.standard_normal((B, H, D), np.float32), dev, dtype),
            _t(rng.standard_normal((P, page, KV, D), np.float32), dev, dtype),
            _t(rng.standard_normal((P, page, KV, D), np.float32), dev, dtype),
            _t(bt, dev), _t(np.asarray(lens, np.int32), dev))


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("B,H,KV,D,P,page,pages,lens,holes", [
    (3, 6, 2, 64, 20, 16, 6, (83, 40, 57), ((0, 2), (2, 0), (2, 1),
                                            (2, 2), (2, 3))),
    (4, 24, 8, 128, 40, 64, 8, (512, 1, 300, 65), ((1, 0), (2, 3))),
    (2, 8, 8, 64, 12, 48, 5, (200, 47), ()),
    (2, 32, 4, 128, 10, 64, 4, (256, 129), ((0, 1),)),
    # one row of 4096 tokens: 32 splits of 2 pages
    (1, 24, 8, 128, 70, 64, 64, (4096,), ()),
    # splits whose pages are all holes (row 0's pages 4-7, row 1's 8-11)
    (2, 24, 8, 128, 80, 64, 40, (2500, 2000),
     ((0, 4), (0, 5), (0, 6), (0, 7), (1, 8), (1, 9), (1, 10), (1, 11))),
    # gemma3-4b's head_dim 256 (G 2), a hole mid-table, an empty row
    (3, 8, 4, 256, 40, 64, 32, (2048, 700, 33), ((0, 3), (2, 0))),
])
def test_paged_attention_kernel_vs_plain(cuda, dt, B, H, KV, D, P, page,
                                         pages, lens, holes):
    from repro_torch.kernels import paged_attention as pa
    rng = np.random.default_rng(0)
    args = _paged(rng, cuda, DTYPES[dt], B, H, KV, D, P, page, pages, lens,
                  holes)
    ops.reset_counts()
    got = ops.paged_attention(*args)
    torch.cuda.synchronize()
    assert ops.counts()["paged_attention"] == {"launches": 1, "plain": 0}
    assert pa.launches == 1
    want = ref.paged_attention_ref(*args)
    torch.testing.assert_close(got.float(), want.float(), **TOL[dt])
    bt = args[3].cpu().numpy()
    for b in range(B):
        if (bt[b] < 0).all():            # nothing visible: zeros, not NaN
            assert bool((got[b] == 0).all())


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("B,C,H,KV,D,S,offs,reals,window", [
    (4, 45, 6, 2, 64, 128, (0, 17, 80, 0), (45, 30, 45, 0), None),
    (2, 96, 24, 8, 128, 256, (0, 100), (96, 96), None),
    (3, 64, 8, 4, 128, 320, (256, 0, 31), (64, 1, 64), 40),
    (2, 1, 24, 8, 128, 256, (0, 200), (1, 1), None),           # C = 1
    (3, 65, 8, 4, 64, 300, (0, 100, 0), (65, 65, 0), 50),      # C = 65
    (1, 1024, 24, 8, 128, 1024, (0,), (1024,), None),           # C = 1024
    # head_dim 256 (gemma3-4b): ragged chunks past a window, and windowed
    # decode rows (C = 1) over a 2048-token view
    (3, 100, 8, 4, 256, 1536, (0, 1300, 0), (100, 77, 0), 1024),
    (4, 1, 8, 4, 256, 2048, (2047, 1024, 3, 0), (1, 1, 1, 0), 1024),
])
def test_chunked_prefill_kernel_vs_plain(cuda, dt, B, C, H, KV, D, S, offs,
                                         reals, window):
    from repro_torch.kernels import chunked_prefill_attention as cpa
    rng = np.random.default_rng(1)
    dtype = DTYPES[dt]
    q = _t(rng.standard_normal((B, C, H, D), np.float32), cuda, dtype)
    k = _t(rng.standard_normal((B, S, KV, D), np.float32), cuda, dtype)
    v = _t(rng.standard_normal((B, S, KV, D), np.float32), cuda, dtype)
    qo = _t(np.asarray(offs, np.int32), cuda)
    kl = _t(np.asarray([o + r if r else 0 for o, r in zip(offs, reals)],
                       np.int32), cuda)
    ops.reset_counts()
    got = ops.chunked_prefill_attention(q, k, v, q_offsets=qo, kv_lens=kl,
                                        window=window)
    torch.cuda.synchronize()
    assert ops.counts()["chunked_prefill_attention"] == {"launches": 1,
                                                         "plain": 0}
    assert cpa.launches == 1
    want = ref.chunked_prefill_attention_ref(q, k, v, qo, kl, window=window)
    torch.testing.assert_close(got.float(), want.float(), **TOL[dt])
    for b, r in enumerate(reals):
        if r == 0:                        # a pad row gives zeros
            assert bool((got[b] == 0).all())


def test_chunked_prefill_static_mode_kernel_vs_plain(cuda):
    rng = np.random.default_rng(2)
    q = _t(rng.standard_normal((2, 70, 4, 64), np.float32), cuda)
    k = _t(rng.standard_normal((2, 200, 2, 64), np.float32), cuda)
    got = ops.chunked_prefill_attention(q, k, k, q_offset=100, kv_len=170)
    with ops.plain_versions():
        want = ops.chunked_prefill_attention(q, k, k, q_offset=100,
                                             kv_len=170)
    torch.testing.assert_close(got, want, **TOL["f32"])


def test_kernel_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    rng = np.random.default_rng(3)
    q, kp, vp, bt, ln = _paged(rng, cuda, torch.float32, 2, 4, 2, 96, 6, 16,
                               2, (20, 9), ())
    with pytest.raises(ValueError, match="head_dim"):
        ops.paged_attention(q, kp, vp, bt, ln)
    q, kp, vp, bt, ln = _paged(rng, cuda, torch.float32, 2, 4, 2, 64, 6, 16,
                               2, (20, 9), ())
    with pytest.raises(TypeError, match="int32"):
        ops.paged_attention(q, kp, vp, bt.long(), ln)
    with pytest.raises(TypeError, match="dtype"):
        ops.paged_attention(q.half(), kp.half(), vp.half(), bt, ln)
    with pytest.raises(ValueError, match="contiguous"):
        ops.paged_attention(q.transpose(0, 1).contiguous().transpose(0, 1),
                            kp, vp, bt, ln)
    qc = _t(rng.standard_normal((1, 8, 4, 64), np.float32), cuda)
    kc = _t(rng.standard_normal((1, 16, 2, 64), np.float32), cuda)
    with pytest.raises(ValueError, match="window"):
        ops.chunked_prefill_attention(qc, kc, kc, window=0)


def _int8_paged(rng, dev, dtype, B, H, KV, D, P, page, pages, lens, holes):
    """The decode inputs of ``_paged`` with the pages quantized by the
    port's write path (``_quantize``) and q in ``dtype``."""
    from repro_torch.models.transformer import _quantize
    q, kp, vp, bt, ln = _paged(rng, dev, torch.float32, B, H, KV, D, P,
                               page, pages, lens, holes)
    k8, ks = _quantize(kp)
    v8, vs = _quantize(vp)
    return q.to(dtype), k8, v8, ks, vs, bt, ln


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("B,H,KV,D,P,page,pages,lens,holes", [
    # G = 1, D = 64, a -1 hole mid-table
    (3, 4, 4, 64, 20, 16, 6, (83, 40, 57), ((0, 2),)),
    # G = 8, D = 128, a row with an all -1 table
    (3, 32, 4, 128, 20, 64, 4, (256, 129, 70), ((1, 0), (1, 1), (1, 2))),
    # pages of 48 and 20 tokens (not a multiple of the 32-token tile)
    (2, 8, 8, 64, 12, 48, 5, (200, 47), ()),
    (4, 24, 8, 128, 40, 20, 8, (150, 1, 99, 160), ((2, 3),)),
    # one row of 4096 tokens (32 splits); splits of holes beside it
    (1, 24, 8, 128, 70, 64, 64, (4096,), ()),
    (2, 24, 8, 128, 80, 64, 40, (2500, 2000),
     ((0, 4), (0, 5), (0, 6), (0, 7))),
    # head_dim 256 (gemma3-4b's global layers), a hole mid-table
    (2, 8, 4, 256, 40, 64, 32, (2048, 500), ((1, 2),)),
])
def test_paged_attention_int8_kernel_vs_plain(cuda, dt, B, H, KV, D, P,
                                              page, pages, lens, holes):
    """Both versions dequantize exactly in fp32, so the limits are those
    of the model-dtype kernel (``TOL``)."""
    from repro_torch.kernels import paged_attention_int8 as pa8
    rng = np.random.default_rng(5)
    q, k8, v8, ks, vs, bt, ln = _int8_paged(rng, cuda, DTYPES[dt], B, H, KV,
                                            D, P, page, pages, lens, holes)
    ops.reset_counts()
    got = ops.paged_attention(q, k8, v8, bt, ln, k_scales=ks, v_scales=vs)
    torch.cuda.synchronize()
    assert ops.counts()["paged_attention_int8"] == {"launches": 1,
                                                    "plain": 0}
    assert ops.counts()["paged_attention"] == {"launches": 0, "plain": 0}
    assert pa8.launches == 1
    assert got.dtype == q.dtype
    want = ref.paged_attention_ref(q, k8, v8, bt, ln, ks, vs)
    torch.testing.assert_close(got.float(), want.float(), **TOL[dt])
    bt_h = bt.cpu().numpy()
    for b in range(B):
        if (bt_h[b] < 0).all():          # nothing visible: zeros, not NaN
            assert bool((got[b] == 0).all())


def test_paged_attention_int8_all_empty_table_gives_zeros(cuda):
    rng = np.random.default_rng(6)
    q, k8, v8, ks, vs, bt, ln = _int8_paged(rng, cuda, torch.bfloat16, 2, 8,
                                            2, 128, 6, 16, 3, (40, 17), ())
    bt.fill_(-1)
    got = ops.paged_attention(q, k8, v8, bt, ln, k_scales=ks, v_scales=vs)
    torch.cuda.synchronize()
    assert bool((got == 0).all())


def test_paged_attention_int8_refuses_what_it_does_not_take(cuda):
    from repro_torch.kernels.paged_attention_int8 import \
        paged_attention_int8_cuda as pa8
    rng = np.random.default_rng(7)
    q, k8, v8, ks, vs, bt, ln = _int8_paged(rng, cuda, torch.float32, 2, 4,
                                            2, 64, 6, 16, 2, (20, 9), ())
    with pytest.raises(TypeError, match="int8"):
        pa8(q, k8.float(), v8.float(), ks, vs, bt, ln)
    with pytest.raises(TypeError, match="bfloat16"):
        pa8(q, k8, v8, ks.float(), vs.float(), bt, ln)
    with pytest.raises(TypeError, match="dtype"):
        pa8(q.half(), k8, v8, ks, vs, bt, ln)
    with pytest.raises(TypeError, match="int32"):
        pa8(q, k8, v8, ks, vs, bt.long(), ln)
    with pytest.raises(ValueError, match="shapes"):
        pa8(q, k8, v8, ks[:, :8].contiguous(), vs[:, :8].contiguous(), bt,
            ln)
    with pytest.raises(ValueError, match="shapes"):      # G = 64 > 32
        pa8(torch.zeros((2, 128, 64), device=cuda), k8, v8, ks, vs, bt, ln)
    with pytest.raises(ValueError, match="contiguous"):
        pa8(q, k8.transpose(1, 2).contiguous().transpose(1, 2), v8, ks, vs,
            bt, ln)
    q96, k96, v96, ks96, vs96, bt96, ln96 = _int8_paged(
        rng, cuda, torch.float32, 2, 4, 2, 96, 6, 16, 2, (20, 9), ())
    with pytest.raises(ValueError, match="head_dim"):
        pa8(q96, k96, v96, ks96, vs96, bt96, ln96)
    with pytest.raises(ValueError, match="CUDA"):
        pa8(q.cpu(), k8, v8, ks, vs, bt, ln)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("quant", [False, True])
def test_paged_attention_rows_are_batch_and_width_invariant(cuda, dt,
                                                            quant):
    """Split-K plans its splits from the table's width and the page size
    alone and merges them in order: each row served alone equals the
    same row in the batch, and the 32-page table widened to 64 columns
    of -1 gives the same output, bit for bit."""
    rng = np.random.default_rng(8)
    B, H, KV, D, page, pages = 5, 24, 8, 128, 64, 32
    shape = (B, H, KV, D, 3 * pages, page, pages, (2048, 1500, 1, 700, 333),
             ((2, 0), (1, 7)))
    if quant:
        q, kp, vp, ks, vs, bt, ln = _int8_paged(rng, cuda, DTYPES[dt],
                                                *shape)
    else:
        q, kp, vp, bt, ln = _paged(rng, cuda, DTYPES[dt], *shape)
        ks = vs = None

    def run(q, bt, ln):
        return ops.paged_attention(q, kp, vp, bt, ln, k_scales=ks,
                                   v_scales=vs)
    full = run(q, bt, ln)
    wide = torch.full((B, 2 * pages), -1, dtype=torch.int32, device=cuda)
    wide[:, :pages] = bt
    assert torch.equal(run(q, wide, ln), full)
    for b in range(B):
        assert torch.equal(run(q[b:b + 1], bt[b:b + 1], ln[b:b + 1]),
                           full[b:b + 1])


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_chunked_prefill_rows_are_batch_width_and_chunk_invariant(cuda, dt):
    """Key tiles start at fixed absolute positions and a masked tile
    leaves the softmax state unchanged: a row alone equals the same row
    in the 4-row batch, a wider cache view (the next page-window bucket)
    and a longer chunk (the next chunk bucket) give the same outputs,
    bit for bit."""
    rng = np.random.default_rng(9)
    dtype = DTYPES[dt]
    B, C, H, KV, D, S = 4, 200, 24, 8, 128, 512
    q = _t(rng.standard_normal((B, C + 56, H, D), np.float32), cuda, dtype)
    k = _t(rng.standard_normal((B, 2 * S, KV, D), np.float32), cuda, dtype)
    v = _t(rng.standard_normal((B, 2 * S, KV, D), np.float32), cuda, dtype)
    qo = _t(np.asarray([0, 100, 37, 0], np.int32), cuda)
    kl = _t(np.asarray([200, 250, 237, 0], np.int32), cuda)

    def run(q, k, v, qo, kl):
        return ops.chunked_prefill_attention(
            q.contiguous(), k.contiguous(), v.contiguous(), q_offsets=qo,
            kv_lens=kl)
    full = run(q[:, :C], k[:, :S], v[:, :S], qo, kl)
    for b in range(B):
        alone = run(q[b:b + 1, :C], k[b:b + 1, :S], v[b:b + 1, :S],
                    qo[b:b + 1], kl[b:b + 1])
        assert torch.equal(alone, full[b:b + 1])
    assert torch.equal(run(q[:, :C], k, v, qo, kl), full)
    assert torch.equal(run(q, k[:, :S], v[:, :S], qo, kl)[:, :C], full)


NORM_TOL = {"f32": dict(atol=1e-6, rtol=2 ** -20),
            "bf16": TOL["bf16"]}


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("N,D", [(1, 3072), (7, 1024), (300, 128),
                                 (5, 1001), (3, 77), (2, 1)])
def test_rmsnorm_kernel_vs_plain(cuda, dt, N, D):
    """Widths that are and are not a multiple of 16 bytes (the kernel
    reads those element by element), one row and many."""
    from repro_torch.kernels import rmsnorm as rms
    rng = np.random.default_rng(4)
    x = _t(rng.standard_normal((N, D), np.float32) * 3, cuda, DTYPES[dt])
    w = _t(rng.standard_normal((D,), np.float32) * 0.1, cuda, DTYPES[dt])
    ops.reset_counts()
    got = ops.rmsnorm(x, w, 1e-5)
    torch.cuda.synchronize()
    assert ops.counts()["rmsnorm"] == {"launches": 1, "plain": 0}
    assert rms.launches == 1
    torch.testing.assert_close(got.float(), ref.rmsnorm_ref(x, w).float(),
                               **NORM_TOL[dt])


def test_rmsnorm_kernel_takes_the_model_layouts(cuda):
    """[B, S, D] activations and the decode batch's [N, 1, D] view go
    through the wrapper's reshape; a dtype mismatch is refused."""
    rng = np.random.default_rng(5)
    x = _t(rng.standard_normal((2, 9, 1024), np.float32), cuda)
    w = _t(rng.standard_normal((1024,), np.float32) * 0.1, cuda)
    got = ops.rmsnorm(x, w)
    assert got.shape == x.shape
    torch.testing.assert_close(got, ref.rmsnorm_ref(x, w), **NORM_TOL["f32"])
    got = ops.rmsnorm(x[:, :1], w)
    torch.testing.assert_close(got, ref.rmsnorm_ref(x[:, :1], w),
                               **NORM_TOL["f32"])
    with pytest.raises(TypeError, match="dtype"):
        ops.rmsnorm(x, w.to(torch.bfloat16))


def _scan_inputs(rng, dev, dtype, B, S, nh, hd, ds, zero_tail=0):
    x = rng.standard_normal((B, S, nh, hd), np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, nh)))).astype(
        np.float32)
    if zero_tail:
        dt[:, S - zero_tail:] = 0.0
    return (_t(x, dev, dtype), _t(dt, dev),
            _t(-np.linspace(1.0, 16.0, nh).astype(np.float32), dev),
            _t(rng.standard_normal((B, S, ds), np.float32), dev, dtype),
            _t(rng.standard_normal((B, S, ds), np.float32), dev, dtype),
            _t(rng.standard_normal((B, nh, hd, ds), np.float32), dev))


def _close_scaled(got, want, rel=5e-4):
    torch.testing.assert_close(got, want, rtol=0,
                               atol=rel * float(want.abs().max()))


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("B,S,nh,hd,ds,chunk,zero_tail", [
    (1, 512, 32, 64, 128, 256, 0),    # full width, two chunks
    (2, 700, 4, 64, 128, 256, 0),     # ragged: the last chunk read in place
    (3, 130, 2, 32, 64, 64, 40),      # ds 64, hd 32, a zero-dt tail
    (1, 64, 8, 16, 128, 64, 0),       # a single chunk, hd = one mma block
    (2, 130, 32, 64, 128, 256, 0),    # one ragged chunk at full width
    (1, 1, 32, 64, 128, 256, 0),      # one token
    (1, 1024, 128, 64, 16, 256, 0),   # jamba-v0.1's d_state 16
    (2, 300, 8, 128, 16, 256, 37),    # d_state 16, hd 128, a zero-dt tail
])
def test_ssd_scan_kernel_vs_plain(cuda, dt, B, S, nh, hd, ds, chunk,
                                  zero_tail):
    from repro_torch.kernels import ssd_scan as ssd
    rng = np.random.default_rng(6)
    args = _scan_inputs(rng, cuda, DTYPES[dt], B, S, nh, hd, ds, zero_tail)
    ops.reset_counts()
    y, h = ops.ssd_scan(*args, chunk=chunk)
    torch.cuda.synchronize()
    assert ops.counts()["ssd_scan"] == {"launches": 1, "plain": 0}
    assert ssd.launches == 1
    assert y.shape == (B, S, nh, hd) and y.dtype == torch.float32
    y_ref, h_ref = ref.ssd_scan_ref(*args, chunk)
    _close_scaled(y, y_ref)
    _close_scaled(h, h_ref)
    if zero_tail:           # the tail leaves the state where the cut does
        cut = [a[:, :S - zero_tail].contiguous() if a.dim() > 1
               and a.shape[1] == S else a for a in args]
        _, h_cut = ops.ssd_scan(*cut, chunk=chunk)
        _close_scaled(h, h_cut)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("S,ds", [(1024, 128), (700, 128), (300, 16)])
def test_ssd_scan_rows_are_batch_invariant(cuda, dt, S, ds):
    """Each row of a 4-row batch alone gives the same y and final state
    as in the batch, bit for bit: no block, scratch or sum order depends
    on the batch. The mixer's strided slices read as their contiguous
    copies, bit for bit."""
    rng = np.random.default_rng(8)
    args = _scan_inputs(rng, cuda, DTYPES[dt], 4, S, 32, 64, ds)
    y, h = ops.ssd_scan(*args, chunk=256)
    for b in range(4):
        ya, ha = ops.ssd_scan(*(a[b:b + 1] if a.dim() > 1 else a
                                for a in args), chunk=256)
        assert torch.equal(ya, y[b:b + 1]) and torch.equal(ha, h[b:b + 1])
    x, dt_, A, B, C, h0 = args
    xBC = torch.cat([x.reshape(4, S, -1), B, C], dim=-1)
    d_in = x.shape[2] * x.shape[3]
    ys, hs = ops.ssd_scan(xBC[..., :d_in].reshape(x.shape), dt_, A,
                          xBC[..., d_in:d_in + ds], xBC[..., d_in + ds:], h0,
                          chunk=256)
    assert torch.equal(ys, y) and torch.equal(hs, h)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("D", [3072, 1024, 1001])
def test_rmsnorm_rows_are_batch_invariant(cuda, dt, D):
    """A row alone, [1, D], equals the same row in [8, D] and in
    [1024, D], bit for bit: the warps per row and the reduction order
    depend on the width alone."""
    from repro_torch.kernels import rmsnorm as rms
    rng = np.random.default_rng(9)
    x = _t(rng.standard_normal((1024, D), np.float32) * 3, cuda, DTYPES[dt])
    w = _t(rng.standard_normal((D,), np.float32) * 0.1, cuda, DTYPES[dt])
    full = rms.rmsnorm_cuda(x, w)
    eight = rms.rmsnorm_cuda(x[:8].contiguous(), w)
    assert torch.equal(eight, full[:8])
    for r in range(8):           # a fresh row: 16-byte aligned at any D
        alone = x[r:r + 1].clone()
        assert torch.equal(rms.rmsnorm_cuda(alone, w), full[r:r + 1])


def test_ssd_scan_kernel_refuses_what_it_does_not_take(cuda):
    rng = np.random.default_rng(7)
    args = _scan_inputs(rng, cuda, torch.float32, 1, 64, 2, 32, 32)
    with pytest.raises(ValueError, match="d_state"):
        ops.ssd_scan(*args, chunk=64)            # d_state 32
    args = _scan_inputs(rng, cuda, torch.float32, 1, 64, 2, 32, 64)
    with pytest.raises(ValueError, match="chunk"):
        ops.ssd_scan(*args, chunk=32)            # not a multiple of 64
    x, dt, A, B, C, h0 = args
    with pytest.raises(TypeError, match="float32"):
        ops.ssd_scan(x, dt.to(torch.bfloat16), A, B, C, h0, chunk=64)
    with pytest.raises(TypeError, match="dtype"):
        ops.ssd_scan(x.to(torch.bfloat16), dt, A, B, C, h0, chunk=64)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("H,KV,D", [(24, 8, 128), (16, 16, 64)])
def test_decode_over_dense_256_token_pages(cuda, dt, H, KV, D):
    """The dense layout's decode read: 8 slots of 2048 positions of a
    [9, 2048, KV, D] cache (the sink row last) viewed as pages of 256
    tokens, one page a split, an iota block table. Against the plain
    version; each row alone equals its row of the batch, bit for bit;
    an empty slot gives zeros."""
    from repro_torch.kernels import paged_attention as pa
    rng = np.random.default_rng(12)
    B, page, n = 8, 256, 8
    assert pa.plan_splits(n, page) == (1, n)
    k = _t(rng.standard_normal((B + 1, n * page, KV, D), np.float32), cuda,
           DTYPES[dt])
    v = _t(rng.standard_normal((B + 1, n * page, KV, D), np.float32), cuda,
           DTYPES[dt])
    q = _t(rng.standard_normal((B, H, D), np.float32), cuda, DTYPES[dt])
    kp = k[:B].view(B * n, page, KV, D)
    vp = v[:B].view(B * n, page, KV, D)
    bt = torch.arange(B * n, dtype=torch.int32, device=cuda).view(B, n)
    ln = _t(np.array([2048, 1500, 1, 700, 256, 257, 1023, 0], np.int32),
            cuda)
    got = ops.paged_attention(q, kp, vp, bt, ln)
    want = ref.paged_attention_ref(q, kp, vp, bt, ln)
    torch.testing.assert_close(got.float(), want.float(), **TOL[dt])
    assert bool((got[7] == 0).all())
    for b in range(B):
        assert torch.equal(ops.paged_attention(q[b:b + 1], kp, vp,
                                               bt[b:b + 1], ln[b:b + 1]),
                           got[b:b + 1])


def test_dense_and_paged_engines_stream_alike_on_the_card(cuda):
    """The reduced llama (head_dim 64, f32) served by the fused engine in
    both layouts on the card, through the plans of
    tests/test_torch_reference.py::drive_plans: the same streams (the
    decode kernel reads 64-token pages in one and 256-token pages in the
    other, so the sums differ in order only). Every read went through the
    kernels: no plain version ran."""
    from repro_torch.configs import get_config
    from repro_torch.core.qos import QoSSpec
    from repro_torch.core.request import Request
    from repro_torch.core.scheduler import BatchPlan
    from repro_torch.engine.torch_backend import TorchEngine

    cfg = get_config("llama3.2-3b").reduced(num_layers=2, d_model=256)
    qos = QoSSpec("q", interactive=True, ttft_slo=1e6, tbt_slo=1e6)
    streams = {}
    for layout in ("paged", "dense"):
        eng = TorchEngine(cfg, n_slots=3, max_len=512, quantum=16, seed=7,
                          kv_layout=layout, device=cuda)
        eng.warm()
        ops.reset_counts()
        reqs = [Request(rid=i, arrival=0.0, prompt_len=40 + 90 * i,
                        decode_len=6, qos=qos) for i in range(3)]
        for r in reqs:
            eng.on_admit(r)
        eng.execute(BatchPlan(prefill=[(reqs[0], 40), (reqs[1], 100)]), 0.)
        reqs[0].prefilled, reqs[1].prefilled = 40, 100
        eng.execute(BatchPlan(prefill=[(reqs[1], 30), (reqs[2], 220)],
                              decode=[reqs[0]]), 0.)
        reqs[1].prefilled, reqs[2].prefilled = 130, 220
        for _ in range(5):
            eng.execute(BatchPlan(decode=reqs), 0.)
        counts = ops.counts()
        assert all(c["plain"] == 0 for c in counts.values())
        assert counts["paged_attention"]["launches"] > 0
        assert counts["chunked_prefill_attention"]["launches"] > 0
        streams[layout] = {rid: list(t) for rid, t in eng.generated.items()}
    assert streams["dense"] == streams["paged"]
