"""The pure-Python side of the scan and norm kernels, on the CPU: the
launch plans of ``csrc/ssd_scan.cu`` (three kernels' grids and the
scratch the wrapper allocates) and of ``csrc/rmsnorm.cu`` (warps per row,
units per lane, rows per block), the wrappers' refusals, which check
shapes, dtypes and layouts before the device so that each rule is
reachable here, and the chunked decomposition the scan kernels compute,
restated in float64 and held against the plain scan, ``ssd_chunked`` and
the Pallas kernel. The kernels themselves run only on the card
(``tests/test_torch_cuda.py``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.models import mamba2 as jmamba  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels import rmsnorm as rms  # noqa: E402
from repro_torch.kernels import ssd_scan as ssd  # noqa: E402


# ---------------------------------------------------------------- the scan

@pytest.mark.parametrize("Bt,S,chunk,nh,hd,ds,want", [
    # mamba2-370m, one 1024-token row: 4 chunks, 2 state tiles a head
    (1, 1024, 256, 32, 64, 128,
     dict(chunks=(4,), state_grid=(8, 32, 1), pass_grid=(8, 32, 1),
          scan_grid=(128, 1, 2))),
    # a ragged last chunk: 700 = 2 x 256 + 188
    (2, 700, 256, 32, 64, 128,
     dict(chunks=(3,), state_grid=(6, 32, 2), pass_grid=(8, 32, 2),
          scan_grid=(96, 2, 2))),
    # one token: one chunk, every tile but the first past S
    (1, 1, 256, 32, 64, 128,
     dict(chunks=(1,), state_grid=(2, 32, 1), pass_grid=(8, 32, 1),
          scan_grid=(32, 1, 2))),
    # jamba-v0.1's d_state 16 at 128 heads: one state tile a head
    (1, 1024, 256, 128, 64, 16,
     dict(chunks=(4,), state_grid=(4, 128, 1), pass_grid=(1, 128, 1),
          scan_grid=(512, 1, 2))),
    # a chunk shorter than the output kernel's 128-row tile
    (3, 130, 64, 2, 32, 64,
     dict(chunks=(3,), state_grid=(3, 2, 3), pass_grid=(2, 2, 3),
          scan_grid=(6, 3, 1))),
    # head_dim 128: two head-dim tiles in both tiled kernels
    (1, 300, 256, 4, 128, 128,
     dict(chunks=(2,), state_grid=(8, 4, 1), pass_grid=(16, 4, 1),
          scan_grid=(8, 2, 2))),
])
def test_ssd_scan_plan(Bt, S, chunk, nh, hd, ds, want):
    p = ssd.plan(Bt, S, chunk, nh, hd, ds)
    nc = want["chunks"][0]
    assert nc == -(-S // chunk)
    for key, value in want.items():
        assert p[key] == value, key
    assert p["states"] == (Bt, nc, nh, hd, ds)
    assert p["decay"] == (Bt, nc, nh)
    assert p["hin"] == (Bt, nc, nh, 2, hd, ds)


@pytest.mark.parametrize("S,chunk,nh,hd,ds", [
    (1024, 256, 32, 64, 128), (700, 256, 32, 64, 128), (130, 64, 2, 32, 64),
    (1, 256, 128, 64, 16)])
def test_ssd_scan_plan_depends_on_the_batch_only_along_its_axis(
        S, chunk, nh, hd, ds):
    """No plan depends on the batch: every grid and scratch shape of a
    batch is the one-row plan with the batch axis scaled, so the blocks
    of a row, and every sum's order, are those of the row alone."""
    one = ssd.plan(1, S, chunk, nh, hd, ds)
    n_dt = -(-hd // ssd.TILE)
    for Bt in (2, 4, 8):
        p = ssd.plan(Bt, S, chunk, nh, hd, ds)
        assert p["chunks"] == one["chunks"]
        for key in ("state_grid", "pass_grid"):
            assert p[key][:2] == one[key][:2] and p[key][2] == Bt
        assert p["scan_grid"][0::2] == one["scan_grid"][0::2]
        assert p["scan_grid"][1] == Bt * n_dt
        for key in ("states", "decay", "hin"):
            assert p[key] == (Bt,) + one[key][1:]


def _scan_args(rng, Bt=1, S=64, nh=2, hd=32, ds=64, dtype=torch.float32):
    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32))
    return (t(Bt, S, nh, hd).to(dtype), t(Bt, S, nh).abs(), -t(nh).abs(),
            t(Bt, S, ds).to(dtype), t(Bt, S, ds).to(dtype),
            t(Bt, nh, hd, ds))


def test_ssd_scan_wrapper_refuses_what_the_kernels_do_not_take():
    rng = np.random.default_rng(0)
    with pytest.raises(ValueError, match="d_state"):
        ssd.ssd_scan_cuda(*_scan_args(rng, ds=32), 64)
    with pytest.raises(ValueError, match="chunk"):
        ssd.ssd_scan_cuda(*_scan_args(rng), 32)           # not 64k
    with pytest.raises(ValueError, match="chunk"):
        ssd.ssd_scan_cuda(*_scan_args(rng), 2048)         # past 1024
    with pytest.raises(ValueError, match="head_dim"):
        ssd.ssd_scan_cuda(*_scan_args(rng, hd=24), 64)
    x, dt, A, B, C, h0 = _scan_args(rng)
    with pytest.raises(TypeError, match="float32"):
        ssd.ssd_scan_cuda(x, dt.to(torch.bfloat16), A, B, C, h0, 64)
    with pytest.raises(TypeError, match="float32"):
        ssd.ssd_scan_cuda(x, dt, A, B, C, h0.double(), 64)
    with pytest.raises(TypeError, match="dtype"):
        ssd.ssd_scan_cuda(x.to(torch.bfloat16), dt, A, B, C, h0, 64)
    with pytest.raises(TypeError, match="dtype"):
        ssd.ssd_scan_cuda(x.half(), dt, A, B.half(), C.half(), h0, 64)
    with pytest.raises(ValueError, match="shapes"):
        ssd.ssd_scan_cuda(x, dt[:, :-1], A, B, C, h0, 64)
    with pytest.raises(ValueError, match="shapes"):
        ssd.ssd_scan_cuda(x, dt, A, B, C[..., :32], h0, 64)
    with pytest.raises(ValueError, match="Bt, S, nh, hd"):
        ssd.ssd_scan_cuda(x[0], dt, A, B, C, h0, 64)
    base = torch.zeros(dt.numel() + 1)
    odd = base[1:].view(dt.shape)          # contiguous, 4 bytes off
    with pytest.raises(ValueError, match="aligned"):
        ssd.ssd_scan_cuda(x, odd, A, B, C, h0, 64)
    # every rule above holds: the device is checked last
    with pytest.raises(ValueError, match="CUDA"):
        ssd.ssd_scan_cuda(x, dt, A, B, C, h0, 64)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_scan_takes_the_mixers_slices_without_a_copy(dtype):
    """x, B and C as the Mamba2 mixer slices them from one projection
    [Bt, S, nh hd + 2 ds] reach the kernels in place, with their batch and
    token strides; a layout the kernels cannot read is copied."""
    Bt, S, nh, hd, ds = 2, 40, 4, 32, 64
    xBC = torch.zeros((Bt, S, nh * hd + 2 * ds), dtype=dtype)
    x = xBC[..., :nh * hd].reshape(Bt, S, nh, hd)
    B = xBC[..., nh * hd:nh * hd + ds]
    C = xBC[..., nh * hd + ds:]
    for t, inner in ((x, 2), (B, 1), (C, 1)):
        assert not t.is_contiguous()
        got = ssd._strided(t, inner)
        assert got.data_ptr() == t.data_ptr() and got.stride() == t.stride()
    # a token stride that is not a multiple of 16 bytes, and a transposed
    # head layout, are copied
    ragged = torch.zeros((Bt, S, ds + 1), dtype=dtype)[..., :ds]
    assert ssd._strided(ragged, 1).is_contiguous()
    swapped = torch.zeros((Bt, S, hd, nh), dtype=dtype).transpose(2, 3)
    assert ssd._strided(swapped, 2).is_contiguous()


def _four_steps(x, dt, A, B, C, h0, chunk):
    """The chunked decomposition the scan kernels compute, in float64,
    with a ragged last chunk read as it is (no padding): 1. each chunk's
    cumulative decay and C.B^T; 2. the chunk states S_k = x^T (B dt
    exp(cum_last - cum)); 3. the state passed through the chunks, H_k =
    exp(cum_last) H_{k-1} + S_k, keeping the state entering each chunk;
    4. the chunk outputs (C.B^T o L o dt) x + exp(cum) C H_in^T."""
    x, dt, A, B, C, h0 = (np.asarray(a, np.float64)
                          for a in (x, dt, A, B, C, h0))
    Bt, S, nh, hd = x.shape
    spans = [slice(t0, min(S, t0 + chunk)) for t0 in range(0, S, chunk)]
    cums, cbs, states = [], [], []
    for sl in spans:                                        # steps 1, 2
        cum = np.cumsum(dt[:, sl] * A, axis=1)              # [Bt, n, nh]
        cums.append(cum)
        cbs.append(np.einsum("bis,bjs->bij", C[:, sl], B[:, sl]))
        scale = dt[:, sl] * np.exp(cum[:, -1:] - cum)
        states.append(np.einsum("bjhd,bjs,bjh->bhds", x[:, sl], B[:, sl],
                                scale))
    h, h_in = h0, []
    for cum, s_k in zip(cums, states):                      # step 3
        h_in.append(h)
        h = np.exp(cum[:, -1])[:, :, None, None] * h + s_k
    y = np.zeros((Bt, S, nh, hd))
    for sl, cum, cb, hk in zip(spans, cums, cbs, h_in):     # step 4
        n = cum.shape[1]
        causal = np.tril(np.ones((n, n), bool))[None, :, :, None]
        diff = np.where(causal, cum[:, :, None] - cum[:, None], -np.inf)
        w = cb[..., None] * np.exp(diff) * dt[:, sl][:, None]
        y[:, sl] = np.einsum("bijh,bjhd->bihd", w, x[:, sl]) \
            + np.einsum("bis,bhds,bih->bihd", C[:, sl], hk, np.exp(cum))
    return y, h


def _ssd_inputs(rng, B, S, nh, hd, ds):
    """As tests/test_kernels.py draws them: x * 0.5, B, C * 0.3, softplus
    dt, A = -exp(0.3 z), a small carried state."""
    x = rng.standard_normal((B, S, nh, hd), np.float32) * 0.5
    dt = np.log1p(np.exp(rng.standard_normal((B, S, nh)))).astype(
        np.float32)
    A = -np.exp(rng.standard_normal((nh,)) * 0.3).astype(np.float32)
    Bm = rng.standard_normal((B, S, ds), np.float32) * 0.3
    Cm = rng.standard_normal((B, S, ds), np.float32) * 0.3
    h0 = rng.standard_normal((B, nh, hd, ds), np.float32) * 0.1
    return x, dt, A, Bm, Cm, h0


def _close_scaled(got, want, rel):
    """Every element within ``rel`` of ``want``'s largest magnitude."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * float(np.abs(want).max()))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("B,S,nh,hd,ds,chunk", [
    (2, 128, 4, 32, 16, 64),
    (1, 192, 2, 16, 64, 64),
    (2, 100, 3, 16, 16, 64),        # ragged: 64 + 36
    (1, 1, 2, 16, 16, 64),          # one token
])
def test_four_step_decomposition_equals_the_scan(seed, B, S, nh, hd, ds,
                                                 chunk):
    """The four steps in float64, the ragged chunk read in place, against
    the plain scan (zero-padded to the chunk grid), ``ssd_chunked`` and,
    where S is a multiple of the chunk, the Pallas kernel in interpret
    mode: within 1e-5 of the output's largest magnitude (the fp32
    versions' summation order only)."""
    rng = np.random.default_rng(seed)
    arrs = _ssd_inputs(rng, B, S, nh, hd, ds)
    y64, h64 = _four_steps(*arrs, chunk)
    y, h = ref.ssd_scan_ref(*(torch.from_numpy(a) for a in arrs), chunk)
    _close_scaled(y.numpy(), y64, 1e-5)
    _close_scaled(h.numpy(), h64, 1e-5)
    j = [jnp.asarray(a) for a in arrs]
    yj, hj = jmamba.ssd_chunked(*j, chunk)
    _close_scaled(yj, y64, 1e-5)
    _close_scaled(hj, h64, 1e-5)
    if S % chunk == 0:
        yp, hp = jops.ssd_scan(*j, chunk=chunk, interpret=True)
        _close_scaled(yp, y64, 1e-5)
        _close_scaled(hp, h64, 1e-5)


# ---------------------------------------------------------------- the norm

@pytest.mark.parametrize("D,dtype,want", [
    (3072, torch.bfloat16, (True, 3, 4, 1)),    # llama3.2-3b
    (3072, torch.float32, (True, 6, 4, 1)),
    (1024, torch.bfloat16, (True, 1, 4, 4)),    # mamba2-370m
    (1024, torch.float32, (True, 2, 4, 2)),
    (4096, torch.bfloat16, (True, 4, 4, 1)),
    (4104, torch.bfloat16, (True, 5, 4, 1)),
    (8192, torch.bfloat16, (True, 8, 4, 1)),    # eight warps at 4 a lane
    (16384, torch.bfloat16, (True, 8, 8, 1)),   # then more units a lane
    (16384, torch.float32, (True, 8, 16, 1)),   # the widest row taken
    (1001, torch.bfloat16, (False, 8, 4, 1)),   # not 16-byte rows
    (77, torch.float32, (False, 1, 4, 4)),
    (1, torch.float32, (False, 1, 1, 4)),
])
def test_rmsnorm_plan(D, dtype, want):
    vec, wpr, upl, rows = rms.plan(D, dtype)
    assert (vec, wpr, upl, rows) == want
    _check_plan(D, dtype, vec, wpr, upl, rows)


def _check_plan(D, dtype, vec, wpr, upl, rows):
    """16-byte units exactly where a row is a multiple of 16 bytes; the
    fewest warps that hold the row at ``LANE_UNITS`` a lane (at most
    eight), the smallest instantiated units per lane that cover it, and
    as many rows a block as four warps hold."""
    es = torch.empty((), dtype=dtype).element_size()
    assert vec == (D * es % 16 == 0)
    units = D // (16 // es) if vec else D
    assert wpr == min(rms.MAX_WARPS,
                      max(1, -(-units // (32 * rms.LANE_UNITS))))
    assert upl in rms.UNITS_PER_LANE and 32 * wpr * upl >= units
    smaller = [u for u in rms.UNITS_PER_LANE if u < upl]
    assert not smaller or 32 * wpr * smaller[-1] < units
    assert rows == max(1, rms.BLOCK_WARPS // wpr)
    assert wpr * rows <= rms.MAX_WARPS


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_plan_is_a_function_of_the_width_alone(dtype):
    """The plan takes only the width and the dtype, so a row's warps and
    reduction order cannot depend on the number of rows; every width up
    to eight warps' registers gets a plan that holds it."""
    for D in list(range(1, 300)) + [1000, 1001, 2048, 3072, 4095, 8192,
                                    16384]:
        _check_plan(D, dtype, *rms.plan(D, dtype))


def test_rmsnorm_wrapper_refuses_what_the_kernel_does_not_take():
    x = torch.zeros((4, 256))
    w = torch.zeros(256)
    with pytest.raises(TypeError, match="dtype"):
        rms.rmsnorm_cuda(x, w.to(torch.bfloat16))
    with pytest.raises(TypeError, match="dtype"):
        rms.rmsnorm_cuda(x.half(), w.half())
    with pytest.raises(ValueError, match="shapes"):
        rms.rmsnorm_cuda(x[None], w)
    with pytest.raises(ValueError, match="shapes"):
        rms.rmsnorm_cuda(x, w[:128])
    with pytest.raises(ValueError, match="contiguous"):
        rms.rmsnorm_cuda(torch.zeros((256, 4)).T, w)
    with pytest.raises(ValueError, match="aligned"):
        rms.rmsnorm_cuda(torch.zeros(4 * 256 + 1)[1:].view(4, 256), w)
    wide = 32 * rms.UNITS_PER_LANE[-1] * rms.MAX_WARPS * 4 + 4
    with pytest.raises(ValueError, match="more than 8 warps"):
        rms.rmsnorm_cuda(torch.zeros((1, wide)), torch.zeros(wide))
    with pytest.raises(ValueError, match="CUDA"):
        rms.rmsnorm_cuda(x, w)
