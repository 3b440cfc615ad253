"""The attention wrappers' pure-Python side, on the CPU: the split-K plan
of the paged decode kernels (``plan_splits``, ``workspace``) and
the refusals of every attention wrapper, which check shapes, dtypes and
layouts before the device so that each rule is reachable here. The
kernels themselves run only on the card (``tests/test_torch_cuda.py``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import paged_attention as pa  # noqa: E402
from repro_torch.kernels.chunked_prefill_attention import \
    chunked_prefill_attention_cuda  # noqa: E402
from repro_torch.kernels.paged_attention_int8 import \
    paged_attention_int8_cuda  # noqa: E402


@pytest.mark.parametrize("n_pages,page,want", [
    (32, 64, (2, 16)),      # the serve paths' widest table: 16 splits
    (64, 64, (2, 32)),      # a 4096-token row
    (16, 64, (2, 8)),       # the profile's page window
    (1, 64, (2, 1)),
    (0, 64, (2, 1)),        # an empty table still has one (empty) split
    (6, 16, (8, 1)),
    (40, 16, (8, 5)),
    (8, 20, (6, 2)),        # pages that do not divide the split's tokens
    (5, 48, (2, 3)),
    (3, 512, (1, 3)),       # pages longer than a split: one page each
])
def test_plan_splits(n_pages, page, want):
    assert pa.plan_splits(n_pages, page) == want
    pages_per_split, n_splits = want
    assert pages_per_split * page >= min(page, pa.SPLIT_TOKENS)
    assert (n_splits - 1) * pages_per_split < max(n_pages, 1)


@pytest.mark.parametrize("n_pages,page", [(32, 64), (17, 16), (9, 48)])
def test_split_plan_depends_on_the_table_alone(n_pages, page):
    """No batch size enters the plan: the workspace of any batch has the
    table's splits. Widening a table by columns of -1 keeps every split's
    pages where they were and only adds splits."""
    n_splits = pa.plan_splits(n_pages, page)[1]
    for B in (1, 3, 8, 64):
        q = torch.zeros((B, 24, 128), dtype=torch.bfloat16)
        ml, acc = pa.workspace(q, n_pages, page)
        assert ml.shape == (2, B, 24, n_splits)
        assert acc.shape == (B, 24, n_splits, 128)
        assert ml.dtype == acc.dtype == torch.float32
        assert ml.device == acc.device == q.device
    wide = pa.plan_splits(2 * n_pages, page)
    assert wide[0] == pa.plan_splits(n_pages, page)[0]
    assert wide[1] >= n_splits


def _decode(rng, B=2, H=4, KV=2, D=64, P=6, page=16, pages=2,
            dtype=torch.float32):
    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a))
    q = t(rng.standard_normal((B, H, D), np.float32)).to(dtype)
    kp = t(rng.standard_normal((P, page, KV, D), np.float32)).to(dtype)
    bt = t(rng.integers(0, P, (B, pages)).astype(np.int32))
    ln = torch.full((B,), page * pages - 3, dtype=torch.int32)
    return q, kp, kp.clone(), bt, ln


def test_paged_attention_wrapper_refuses_what_the_kernel_does_not_take():
    rng = np.random.default_rng(0)
    q, kp, vp, bt, ln = _decode(rng, D=96)
    with pytest.raises(ValueError, match="head_dim"):
        pa.paged_attention_cuda(q, kp, vp, bt, ln)
    q, kp, vp, bt, ln = _decode(rng)
    with pytest.raises(TypeError, match="int32"):
        pa.paged_attention_cuda(q, kp, vp, bt.long(), ln)
    with pytest.raises(TypeError, match="dtype"):
        pa.paged_attention_cuda(q.half(), kp.half(), vp.half(), bt, ln)
    with pytest.raises(TypeError, match="dtype"):
        pa.paged_attention_cuda(q, kp.to(torch.bfloat16), vp, bt, ln)
    with pytest.raises(ValueError, match="contiguous"):
        pa.paged_attention_cuda(q.transpose(0, 1).contiguous()
                                .transpose(0, 1), kp, vp, bt, ln)
    with pytest.raises(ValueError, match="shapes"):          # G = 64
        pa.paged_attention_cuda(torch.zeros((2, 128, 64)), kp, vp, bt, ln)
    with pytest.raises(ValueError, match="shapes"):
        pa.paged_attention_cuda(q, kp, vp, bt[:1].contiguous(), ln)
    with pytest.raises(ValueError, match="CUDA"):            # all else fine
        pa.paged_attention_cuda(q, kp, vp, bt, ln)
    assert pa.launches == 0


def test_paged_attention_int8_wrapper_refuses_what_the_kernel_does_not_take():
    rng = np.random.default_rng(1)
    q, kp, _, bt, ln = _decode(rng)
    k8 = torch.zeros(kp.shape, dtype=torch.int8)
    sc = torch.ones(kp.shape[:3], dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="int8"):
        paged_attention_int8_cuda(q, kp, kp, sc, sc, bt, ln)
    with pytest.raises(TypeError, match="bfloat16"):
        paged_attention_int8_cuda(q, k8, k8, sc.float(), sc.float(), bt, ln)
    with pytest.raises(ValueError, match="shapes"):
        paged_attention_int8_cuda(q, k8, k8, sc[:, :8].contiguous(),
                                  sc[:, :8].contiguous(), bt, ln)
    with pytest.raises(ValueError, match="contiguous"):
        paged_attention_int8_cuda(
            q, k8.transpose(1, 2).contiguous().transpose(1, 2), k8, sc, sc,
            bt, ln)
    with pytest.raises(TypeError, match="dtype"):
        paged_attention_int8_cuda(q.half(), k8, k8, sc, sc, bt, ln)
    with pytest.raises(ValueError, match="CUDA"):
        paged_attention_int8_cuda(q, k8, k8, sc, sc, bt, ln)


def test_chunked_prefill_wrapper_refuses_what_the_kernel_does_not_take():
    rng = np.random.default_rng(2)

    def inputs(C=8, H=4, KV=2, D=64, S=16):
        q = torch.from_numpy(rng.standard_normal((1, C, H, D), np.float32))
        k = torch.from_numpy(rng.standard_normal((1, S, KV, D), np.float32))
        i32 = dict(dtype=torch.int32)
        return q, k, torch.zeros(1, **i32), torch.full((1,), C, **i32)
    q, k, qo, kl = inputs(D=96)
    with pytest.raises(ValueError, match="head_dim"):
        chunked_prefill_attention_cuda(q, k, k, qo, kl)
    q, k, qo, kl = inputs()
    with pytest.raises(ValueError, match="window"):
        chunked_prefill_attention_cuda(q, k, k, qo, kl, window=0)
    with pytest.raises(TypeError, match="int32"):
        chunked_prefill_attention_cuda(q, k, k, qo.long(), kl)
    with pytest.raises(TypeError, match="dtype"):
        chunked_prefill_attention_cuda(q.to(torch.bfloat16), k, k, qo, kl)
    with pytest.raises(ValueError, match="shapes"):          # H % KV
        chunked_prefill_attention_cuda(inputs(H=3)[0], k, k, qo, kl)
    with pytest.raises(ValueError, match="CUDA"):
        chunked_prefill_attention_cuda(q, k, k, qo, kl)
