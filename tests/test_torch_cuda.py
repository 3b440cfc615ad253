"""The port's CUDA kernels against their plain PyTorch versions, on the
card: the engine's edge cases at small shapes (G = 3, -1 holes mid-table,
lens not a multiple of the page, fully masked rows, ragged chunks, pad
rows, windows) and the wrappers' refusals. ``chip_smoke.py`` checks the
same kernels at the main path's shapes.

On a machine with an NVIDIA GPU and nvcc:

  PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Elsewhere every test here skips. Tolerances, element by element as
``atol + rtol * |plain|``: 1e-4 in f32 (summation order; TF32 is off);
in bf16 one bf16 ulp of the output (rtol 2^-7, atol 1e-5), since kernel
and plain version both accumulate in fp32 and round the output once.
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
