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
against the same row in a batch), the norm's backward kernel (against
``rmsnorm_bwd_ref`` at 1, 9 and 4097 rows too, a row's dx alone against
the batch at every grid, dw the same from run to run, the autograd
Function launching both kernels), the
scan's backward kernel (against ``ssd_scan_bwd_ref`` at the forward's
shapes, a row's dx, ddt, dB, dC and dh0 alone against the batch, dA the
same from run to run, the autograd Function launching both kernels), the
attention kernels, which have no backward, refusing inputs that require
a gradient, and the wrappers' refusals. ``chip_smoke.py`` checks the
same kernels at the main paths' shapes.

On a machine with an NVIDIA GPU and nvcc:

  PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Elsewhere every test here skips. Tolerances, element by element as
``atol + rtol * |plain|``: 1e-4 in f32 (summation order; TF32 is off);
in bf16 one bf16 ulp of the output (rtol 2^-7, atol 1e-5), since kernel
and plain version both accumulate in fp32 and round the output once.
The norm in f32 is held to 8 ulps (rtol 2^-20, atol 1e-6), and the scan,
whose output is fp32 in either input dtype, to 5e-4 of its output's
largest magnitude (the versions sum the chunk's cumulative decay in
different orders; ``chip_smoke.py``'s ``SSD_REL``); the scan's gradients
likewise, each relative to its own largest magnitude, and in bf16 (dx, dB
and dC) one bf16 ulp of the element besides.
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


# the norm's backward, dx: f32 within 1e-5 plus 8 ulps (a difference of
# two rounded fp32 terms, row sums in other orders), bf16 one bf16 ulp;
# dw (fp32): within 2^-14 of each column's sum of |dy x r| (two orders
# of a sum of N terms, N <= 5000 here: each within (N - 1) 2^-24)
NORM_BWD_TOL = {"f32": dict(atol=1e-5, rtol=2 ** -20), "bf16": TOL["bf16"]}


def _norm_bwd_inputs(rng, dev, dtype, N, D):
    return (_t(rng.standard_normal((N, D), np.float32) * 3, dev, dtype),
            _t(rng.standard_normal((D,), np.float32) * 0.1, dev, dtype),
            _t(rng.standard_normal((N, D), np.float32), dev, dtype))


def _dw_close(dw, x, w, dy, want):
    xf = x.float()
    r = torch.rsqrt((xf * xf).mean(-1, keepdim=True) + 1e-5)
    mag = (dy.float() * xf * r).abs().sum(0)
    assert bool(((dw - want).abs() <= 2 ** -14 * mag + 1e-7).all())


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("N,D", [(1, 3072), (1024, 3072), (1024, 768),
                                 (7, 2048), (300, 2560), (5000, 128),
                                 (5, 1001), (3, 77), (2, 1), (4097, 768),
                                 (9, 1024), (13, 2048), (1023, 1028),
                                 (4097, 2056)])
def test_rmsnorm_bwd_kernel_vs_plain(cuda, dt, N, D):
    """The backward at the trained widths, rows that are not a multiple
    of 16 bytes wide, one row, and groups that take several rows (5000
    rows of 128: 1252 groups)."""
    from repro_torch.kernels import rmsnorm as rms
    x, w, dy = _norm_bwd_inputs(np.random.default_rng(14), cuda,
                                DTYPES[dt], N, D)
    ops.reset_counts()
    dx, dw = ops.rmsnorm_bwd(x, w, dy, 1e-5)
    torch.cuda.synchronize()
    assert ops.counts()["rmsnorm_bwd"] == {"launches": 1, "plain": 0}
    assert rms.bwd_launches == 1
    assert dx.dtype == x.dtype and dw.dtype == torch.float32
    want_dx, want_dw = ref.rmsnorm_bwd_ref(x, w, dy, 1e-5)
    torch.testing.assert_close(dx.float(), want_dx.float(),
                               **NORM_BWD_TOL[dt])
    _dw_close(dw, x, w, dy, want_dw)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("D", [3072, 768, 1001])
def test_rmsnorm_bwd_rows_alone_and_dw_deterministic(cuda, dt, D):
    """A row alone gives the batch's dx, bit for bit; two runs give the
    same dw, bit for bit."""
    from repro_torch.kernels import rmsnorm as rms
    x, w, dy = _norm_bwd_inputs(np.random.default_rng(15), cuda,
                                DTYPES[dt], 1024, D)
    dx, dw = rms.rmsnorm_bwd_cuda(x, w, dy)
    for r in (0, 3, 1023):
        alone, _ = rms.rmsnorm_bwd_cuda(x[r:r + 1].clone(), w,
                                        dy[r:r + 1].clone())
        assert torch.equal(alone, dx[r:r + 1])
    assert torch.equal(rms.rmsnorm_bwd_cuda(x, w, dy)[1], dw)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("D", [768, 1024, 2048, 3072, 1001, 77])
def test_rmsnorm_bwd_rows_alone_at_every_grid(cuda, dt, D):
    """The backward's plan depends on the width alone: a row of 1, 9 (not
    a multiple of a block's groups), 1024 and 4097 rows (past the grid's
    cap: groups that take several rows) gives the same dx bit for bit; dw
    at each N the same from run to run and within the plain version's
    limit."""
    from repro_torch.kernels import rmsnorm as rms
    x, w, dy = _norm_bwd_inputs(np.random.default_rng(18), cuda,
                                DTYPES[dt], 4097, D)
    full, _ = rms.rmsnorm_bwd_cuda(x, w, dy)
    for N in (1, 9, 1024, 4097):
        dx, dw = rms.rmsnorm_bwd_cuda(x[:N].clone(), w, dy[:N].clone())
        assert torch.equal(dx, full[:N])
        assert torch.equal(rms.rmsnorm_bwd_cuda(x[:N].clone(), w,
                                                dy[:N].clone())[1], dw)
        _dw_close(dw, x[:N], w, dy[:N], ref.rmsnorm_bwd_ref(
            x[:N], w, dy[:N], 1e-5)[1])


def test_rmsnorm_function_runs_both_kernels_on_the_card(cuda):
    """With gradients on the card, ``ops.rmsnorm`` launches the forward
    and backward kernels once each and runs no plain version; its
    gradients are the backward kernel's."""
    from repro_torch.kernels import rmsnorm as rms
    x, w, dy = _norm_bwd_inputs(np.random.default_rng(16), cuda,
                                torch.float32, 2 * 9, 1024)
    x = x.reshape(2, 9, 1024).requires_grad_()
    w = w.requires_grad_()
    ops.reset_counts()
    y = ops.rmsnorm(x, w)
    gx, gw = torch.autograd.grad(y, (x, w), dy.reshape(2, 9, 1024))
    torch.cuda.synchronize()
    c = ops.counts()
    assert c["rmsnorm"] == {"launches": 1, "plain": 0}
    assert c["rmsnorm_bwd"] == {"launches": 1, "plain": 0}
    dx, dw = rms.rmsnorm_bwd_cuda(x.detach().reshape(-1, 1024), w.detach(),
                                  dy)
    assert torch.equal(gx.reshape(-1, 1024), dx) and torch.equal(gw, dw)


def test_kernels_without_backward_refuse_grad_on_the_card(cuda):
    rng = np.random.default_rng(17)
    q = _t(rng.standard_normal((1, 8, 4, 64), np.float32), cuda)
    k = _t(rng.standard_normal((1, 8, 2, 64), np.float32), cuda)
    q.requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        ops.chunked_prefill_attention(q, k, k)
    with torch.no_grad():
        assert ops.chunked_prefill_attention(q, k, k).shape == q.shape


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


SCAN_SHAPES = [
    (1, 512, 32, 64, 128, 256, 0),    # full width, two chunks
    (2, 700, 4, 64, 128, 256, 0),     # ragged: the last chunk read in place
    (3, 130, 2, 32, 64, 64, 40),      # ds 64, hd 32, a zero-dt tail
    (1, 64, 8, 16, 128, 64, 0),       # a single chunk, hd = one mma block
    (2, 130, 32, 64, 128, 256, 0),    # one ragged chunk at full width
    (1, 1, 32, 64, 128, 256, 0),      # one token
    (1, 1024, 128, 64, 16, 256, 0),   # jamba-v0.1's d_state 16
    (2, 300, 8, 128, 16, 256, 37),    # d_state 16, hd 128, a zero-dt tail
]


def _close_scaled(got, want, rel=5e-4):
    torch.testing.assert_close(got, want, rtol=0,
                               atol=rel * float(want.abs().max()))


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("B,S,nh,hd,ds,chunk,zero_tail", SCAN_SHAPES)
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


def _close_grads(got, want, bf16):
    """Each gradient within 5e-4 of its largest magnitude, plus one bf16
    ulp of the element where it is rounded to bf16."""
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert bool(torch.isfinite(g.float()).all())
        rtol = 2 ** -7 if bf16 and g.dtype == torch.bfloat16 else 0.0
        torch.testing.assert_close(
            g.float(), w.float(), rtol=rtol,
            atol=5e-4 * float(w.float().abs().max()) + 1e-30)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("B,S,nh,hd,ds,chunk,zero_tail", SCAN_SHAPES)
def test_ssd_scan_bwd_kernel_vs_plain(cuda, dt, B, S, nh, hd, ds, chunk,
                                      zero_tail):
    from repro_torch.kernels import ssd_scan as ssd
    rng = np.random.default_rng(10)
    args = _scan_inputs(rng, cuda, DTYPES[dt], B, S, nh, hd, ds, zero_tail)
    dy = _t(rng.standard_normal((B, S, nh, hd), np.float32), cuda)
    dh = _t(rng.standard_normal((B, nh, hd, ds), np.float32), cuda)
    ops.reset_counts()
    got = ops.ssd_scan_bwd(*args, dy, dh, chunk=chunk)
    torch.cuda.synchronize()
    assert ops.counts()["ssd_scan_bwd"] == {"launches": 1, "plain": 0}
    assert ssd.bwd_launches == 1
    _close_grads(got, ref.ssd_scan_bwd_ref(*args, dy, dh, chunk),
                 dt == "bf16")
    if zero_tail:           # the zero-dt rows get no dx
        assert not got[0][:, S - zero_tail:].float().any()


# the backward's groups and tiles: small_100m's 24 heads at chunk 64,
# head_dim 16 and 32 (four heads a group) with 3 and 5 heads (a short last
# group), head_dim 128 (one head a dx block), chunk 512, d_state 16, 64
# and 128, lengths off the tile grid and zero-dt tails
SCAN_BWD_SHAPES = [
    (8, 128, 24, 64, 128, 64, 0),
    (2, 200, 3, 16, 64, 64, 30),
    (3, 257, 5, 32, 16, 128, 0),
    (1, 1000, 4, 64, 64, 512, 100),
    (2, 129, 6, 128, 128, 64, 1),
    (1, 63, 2, 64, 16, 64, 0),
]


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("B,S,nh,hd,ds,chunk,zero_tail", SCAN_BWD_SHAPES)
def test_ssd_scan_bwd_groups_and_tiles(cuda, dt, B, S, nh, hd, ds, chunk,
                                       zero_tail):
    """Against the plain version as above; each row of the batch alone
    gives its dx, ddt, dB, dC and dh0, bit for bit; two runs the same dA
    and dB."""
    rng = np.random.default_rng(13)
    args = _scan_inputs(rng, cuda, DTYPES[dt], B, S, nh, hd, ds, zero_tail)
    dy = _t(rng.standard_normal((B, S, nh, hd), np.float32), cuda)
    dh = _t(rng.standard_normal((B, nh, hd, ds), np.float32), cuda)
    got = ops.ssd_scan_bwd(*args, dy, dh, chunk=chunk)
    _close_grads(got, ref.ssd_scan_bwd_ref(*args, dy, dh, chunk),
                 dt == "bf16")
    if zero_tail:
        assert not got[0][:, S - zero_tail:].float().any()
    for b in range(B):
        # a row's slices copied: at nh 3 or 5 a row of dt is not 16-byte
        # aligned in place, which the wrapper refuses
        alone = ops.ssd_scan_bwd(*(a[b:b + 1].clone() if a.dim() > 1 else a
                                   for a in args), dy[b:b + 1].clone(),
                                 dh[b:b + 1].clone(), chunk=chunk)
        for i in (0, 1, 3, 4, 5):
            assert torch.equal(alone[i], got[i][b:b + 1])
    again = ops.ssd_scan_bwd(*args, dy, dh, chunk=chunk)
    assert torch.equal(again[2], got[2]) and torch.equal(again[3], got[3])


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("S,ds", [(1024, 128), (700, 128), (300, 16)])
def test_ssd_scan_bwd_rows_alone_and_dA_deterministic(cuda, dt, S, ds):
    """Each row of a 4-row batch alone gives the same dx, ddt, dB, dC and
    dh0 as in the batch, bit for bit; two runs give the same dA."""
    rng = np.random.default_rng(11)
    args = _scan_inputs(rng, cuda, DTYPES[dt], 4, S, 32, 64, ds)
    dy = _t(rng.standard_normal((4, S, 32, 64), np.float32), cuda)
    dh = _t(rng.standard_normal((4, 32, 64, ds), np.float32), cuda)
    got = ops.ssd_scan_bwd(*args, dy, dh, chunk=256)
    for b in range(4):
        alone = ops.ssd_scan_bwd(*(a[b:b + 1] if a.dim() > 1 else a
                                   for a in args), dy[b:b + 1], dh[b:b + 1],
                                 chunk=256)
        for i in (0, 1, 3, 4, 5):
            assert torch.equal(alone[i], got[i][b:b + 1])
    assert torch.equal(ops.ssd_scan_bwd(*args, dy, dh, chunk=256)[2],
                       got[2])


def test_ssd_scan_function_runs_both_kernels_on_the_card(cuda):
    """With inputs that require a gradient, ``ops.ssd_scan`` launches the
    forward kernels once and the backward kernels once, and its
    gradients are the backward wrapper's, bit for bit."""
    from repro_torch.kernels import ssd_scan as ssd
    rng = np.random.default_rng(12)
    args = _scan_inputs(rng, cuda, torch.float32, 2, 300, 8, 64, 128)
    leaves = [a.clone().requires_grad_() for a in args]
    dy = _t(rng.standard_normal((2, 300, 8, 64), np.float32), cuda)
    ops.reset_counts()
    y, h = ops.ssd_scan(*leaves, chunk=256)
    grads = torch.autograd.grad(y, leaves, dy)
    torch.cuda.synchronize()
    c = ops.counts()
    assert c["ssd_scan"] == {"launches": 1, "plain": 0}
    assert c["ssd_scan_bwd"] == {"launches": 1, "plain": 0}
    want = ssd.ssd_scan_bwd_cuda(*args, dy, torch.zeros_like(args[5]), 256)
    for g, w in zip(grads, want):
        assert torch.equal(g, w)


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


# ---------------------------------------------------------------- decode graphs
# TorchEngine's decode sub-batch replayed from CUDA graphs against the same
# passes run eagerly (``_capture`` off), through the plain scheduler of
# tests/test_torch_decode_graphs.py::drive: 4 slots, 16-token pages,
# admissions, releases and the rungs 1-4, 8 and 16.

GRAPH_PATHS = {"bf16": ("llama3.2-3b", "paged", False),
               "int8": ("llama3.2-3b", "paged", True),
               "dense": ("llama3.2-3b", "dense", False),
               "swa": ("gemma3-4b", "paged", False),
               "mamba": ("mamba2-370m", "paged", False)}


def _graph_engine(device, path, **kw):
    """A warmed bf16 engine of ``GRAPH_PATHS[path]`` at d_model 256 (head
    dim 64); a Mamba config takes the scan kernel's d_state 64 and chunk
    64."""
    import dataclasses

    from test_torch_decode_graphs import make, tiny

    arch, layout, quant = GRAPH_PATHS[path]
    cfg = tiny(arch, d_model=256)
    if cfg.ssm is not None:
        cfg = dataclasses.replace(cfg, ssm=dataclasses.replace(
            cfg.ssm, d_state=64, chunk=64))
    eng = make(cfg, layout, device=device, dtype=torch.bfloat16,
               kv_quant=quant, **kw)
    eng.warm()
    return eng


@pytest.mark.parametrize("path", list(GRAPH_PATHS))
def test_decode_graphs_stream_what_eager_passes_stream(cuda, path):
    """Over 40 steps or more, the graphs' token streams and every page,
    slot row and state row (the sink's aside) equal the eager passes' bit
    for bit; every decode pass was a replay, one capture a rung."""
    from test_torch_decode_graphs import assert_same_cache, drive

    eager, graphed = _graph_engine(cuda, path), _graph_engine(cuda, path)
    eager._capture = False
    assert graphed._split and graphed._capture
    steps = drive(eager)
    assert drive(graphed) == steps >= 40
    assert graphed.generated == eager.generated
    assert_same_cache(graphed.cache, eager.cache)
    assert graphed.eager_decode_steps == 0
    assert graphed.graph_replays == eager.eager_decode_steps > 0
    assert graphed.jit_compiles == graphed.graph_captures \
        == len(graphed._graphs) >= (3 if graphed.paged else 1)
    assert eager.graph_captures == eager.graph_replays == 0


@pytest.mark.parametrize("path", ["bf16", "int8", "dense", "mamba"])
def test_decode_capture_moves_no_live_state(cuda, path):
    """Capturing every rung anew mid-run leaves every page, slot row and
    state row as it was (the sink's aside), and the run then streams what
    an eager run streams."""
    from test_torch_decode_graphs import (QOS, _clone, assert_same_cache,
                                          drive)
    from repro_torch.core.request import Request
    from repro_torch.core.scheduler import BatchPlan

    eng = _graph_engine(cuda, path)
    r = Request(rid=100, arrival=0.0, prompt_len=40, decode_len=20,
                qos=QOS)
    eng.on_admit(r)
    eng.execute(BatchPlan(prefill=[(r, 40)]), 0.0)
    r.prefilled = 40
    for _ in range(3):
        eng.execute(BatchPlan(decode=[r]), 0.0)
    torch.cuda.synchronize()
    before = _clone(eng.cache)
    eng._graphs.clear()
    for m in (eng._maxb_ladder() if eng.paged else [1]):
        eng._capture_rung(m)
    torch.cuda.synchronize()
    assert_same_cache(before, eng.cache)
    eng.on_release(r)
    eager = _graph_engine(cuda, path)
    eager._capture = False
    drive(eng)
    drive(eager)
    del eng.generated[100]
    assert eng.generated == eager.generated


@pytest.mark.parametrize("path", ["bf16", "int8"])
def test_decode_graph_replays_count_as_eager_launches(cuda, path):
    """``ops.counts()``, ``variants()`` and ``heads()`` after a run of
    replays equal those after the same run of eager passes: a capture's
    warm-up and capture are taken back, each replay adds one pass."""
    from test_torch_decode_graphs import drive

    eager, graphed = _graph_engine(cuda, path), _graph_engine(cuda, path)
    eager._capture = False
    got = []
    for eng in (eager, graphed):
        ops.reset_counts()
        drive(eng)
        got.append((ops.counts(), ops.variants(), ops.heads()))
    assert graphed.graph_replays > 0
    assert got[1] == got[0]


def test_decode_graphs_capture_on_two_threads(cuda):
    """Two engines stepped on two threads at once (as the async fleet
    steps its engines) capture and replay without error, and stream what
    one eager engine streams."""
    import threading

    from test_torch_decode_graphs import drive

    engines = [_graph_engine(cuda, "bf16") for _ in range(2)]
    errors = []

    def run(eng):
        try:
            drive(eng)
        except BaseException as e:     # noqa: BLE001 - reported below
            errors.append(e)
    threads = [threading.Thread(target=run, args=(e,)) for e in engines]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
    eager = _graph_engine(cuda, "bf16")
    eager._capture = False
    drive(eager)
    for eng in engines:
        assert eng.graph_captures >= 3 and eng.eager_decode_steps == 0
        assert eng.generated == eager.generated



def test_capture_counts_its_own_thread_alone(cuda):
    """One engine captures and replays its decode passes while a second
    engine on another thread runs eager prefill steps all the while:
    ``ops.tally()`` (launches, plain calls, variants, heads) then equals
    that of the same runs done eagerly one after the other, so none of
    the second engine's launches enters the first's captured counts or
    is taken back with its capture."""
    import threading

    from test_torch_decode_graphs import QOS, drive
    from repro_torch.core.request import Request
    from repro_torch.core.scheduler import BatchPlan

    def engines(capture):
        a, b = _graph_engine(cuda, "bf16"), _graph_engine(cuda, "bf16")
        a._capture = capture
        r = Request(rid=0, arrival=0.0, prompt_len=64, decode_len=1,
                    qos=QOS)
        b.on_admit(r)
        ops.reset_counts()
        return a, b, r

    def prefill(b, r):
        # the same 64 prompt tokens again: a prefill-only step
        r.prefilled = 0
        b.slot_len[b.slot_of[r.rid]] = 0
        b.execute(BatchPlan(prefill=[(r, 64)]), 0.0)

    a, b, r = engines(True)
    done, errors, n = threading.Event(), [], [0]

    def run():
        try:
            while not done.is_set():
                prefill(b, r)
                n[0] += 1
        except BaseException as e:     # noqa: BLE001 - reported below
            errors.append(e)
    t = threading.Thread(target=run)
    t.start()
    try:
        drive(a)
    finally:
        done.set()
        t.join()
    torch.cuda.synchronize()
    assert not errors, errors
    got = ops.tally()
    assert a.graph_captures >= 3 and a.eager_decode_steps == 0 and n[0]

    a, b, r = engines(False)
    drive(a)
    for _ in range(n[0]):
        prefill(b, r)
    torch.cuda.synchronize()
    assert a.graph_replays == 0
    assert got == ops.tally()

# the sync audit of the decode pass: (arch, layout, int8 pages, moe_impl)
AUDIT = {"llama": ("llama3.2-3b", "paged", False, "grouped"),
         "int8": ("llama3.2-3b", "paged", True, "grouped"),
         "dense": ("llama3.2-3b", "dense", False, "grouped"),
         "swa": ("gemma3-4b", "paged", False, "grouped"),
         "mamba": ("mamba2-370m", "paged", False, "grouped"),
         "moe-grouped": ("qwen3-moe-30b-a3b", "paged", False, "grouped"),
         "moe-dropless": ("qwen3-moe-30b-a3b", "paged", False, "dropless")}


@pytest.mark.parametrize("name", list(AUDIT))
def test_decode_pass_reads_the_host_only_where_graphs_stay_off(cuda, name):
    """The decode pass alone under ``torch.cuda.set_sync_debug_mode(
    "error")``: it synchronises with the host exactly where
    ``graphs_engage`` keeps the engine eager (the grouped MoE's segment
    read)."""
    import dataclasses

    from test_torch_decode_graphs import QOS, make, tiny
    from repro_torch.core.request import Request
    from repro_torch.core.scheduler import BatchPlan
    from repro_torch.engine.torch_backend import graphs_engage

    arch, layout, quant, impl = AUDIT[name]
    cfg = tiny(arch, d_model=256)
    if cfg.ssm is not None:
        cfg = dataclasses.replace(cfg, ssm=dataclasses.replace(
            cfg.ssm, d_state=64, chunk=64))
    eng = make(cfg, layout, device=cuda, dtype=torch.bfloat16,
               kv_quant=quant, moe_impl=impl)
    eng.warm()
    r = Request(rid=0, arrival=0.0, prompt_len=40, decode_len=8, qos=QOS)
    eng.on_admit(r)
    eng.execute(BatchPlan(prefill=[(r, 40)]), 0.0)
    r.prefilled = 40
    eng.execute(BatchPlan(decode=[r]), 0.0)
    maxb = eng._dec_bt_host.shape[1] if eng.paged else 1
    active = np.zeros((eng.n_slots,), bool)
    active[eng.slot_of[0]] = True
    eng._stage_decode(active, maxb)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        eng._decode_forward(maxb)
        synced = False
    except RuntimeError as e:
        assert "synchroniz" in str(e), e
        synced = True
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert synced == (not graphs_engage(cfg, eng.device, 1, impl))
    assert eng._split == (not synced)


def test_profiler_sees_every_replayed_decode_kernel(cuda):
    """Under ``torch.profiler`` (captures included), the trace holds both
    decode kernels of every layer of every replayed pass and of every
    capture's warm-up run."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from test_torch_decode_graphs import drive

    eng = _graph_engine(cuda, "bf16")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        drive(eng)
        torch.cuda.synchronize()
    kernels = [e.name for e in prof.events()
               if e.device_type == DeviceType.CUDA]
    partial = sum("paged_decode_partial" in k for k in kernels)
    combine = sum("paged_decode_combine" in k for k in kernels)
    want = eng.cfg.num_layers * (eng.graph_replays + eng.graph_captures)
    assert eng.graph_replays > 0
    assert partial == combine == want, (partial, combine, want)
