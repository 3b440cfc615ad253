"""The scan's gradient on the CPU: ``ref.ssd_scan_bwd_ref`` (the chunked
decomposition the backward kernels follow, written out) against
``jax.vjp`` of the JAX package's ``models/mamba2.py::ssd_chunked`` and
against ``torch.autograd`` of ``ref.ssd_scan_ref``; the kernels' step
decomposition restated in float64 (a ragged last chunk read in place, as
the kernels read it); the backward wrapper's launch plan and refusals,
which it checks before the device; and the ``ssd_scan`` autograd
Function's wiring on the kernel route (its forward and backward the two
wrappers, forced here with stubs that run the plain versions). The
kernels themselves run only on the card (``tests/test_torch_cuda.py``).

Inputs are drawn with numpy from a seed as ``tests/test_kernels.py``
draws the scan's (x * 0.5, B and C * 0.3, softplus dt, A = -exp(0.3 z),
a small carried state), with N(0, 1) output gradients. Tolerance: each
gradient within ``REL`` of its largest magnitude. The plain backward
computes in fp64, ``jax.vjp`` and autograd of the plain scan in fp32, so
the difference is the fp32 versions' rounding; dA, a sum over every row
and chunk of terms that cancel, moves most.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import mamba2 as jmamba  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import ssd_scan as ssd  # noqa: E402

REL = 5e-5
NAMES = ("x", "dt", "A", "B", "C", "h0")

# (Bt, S, nh, hd, ds, chunk, zero_tail)
CASES = {
    "ds16": (2, 128, 4, 16, 16, 64, 0),
    "ds128": (1, 128, 2, 16, 128, 64, 0),
    "ragged": (2, 130, 3, 16, 32, 64, 0),       # 64 + 64 + 2
    "one_chunk": (2, 64, 2, 32, 16, 64, 0),
    "zero_dt_tail": (2, 100, 3, 16, 16, 64, 20),
}


def _inputs(seed, Bt, S, nh, hd, ds, zero_tail=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((Bt, S, nh, hd), np.float32) * 0.5
    dt = np.log1p(np.exp(rng.standard_normal((Bt, S, nh)))).astype(
        np.float32)
    if zero_tail:
        dt[:, S - zero_tail:] = 0.0
    A = -np.exp(rng.standard_normal((nh,)) * 0.3).astype(np.float32)
    Bm = rng.standard_normal((Bt, S, ds), np.float32) * 0.3
    Cm = rng.standard_normal((Bt, S, ds), np.float32) * 0.3
    h0 = rng.standard_normal((Bt, nh, hd, ds), np.float32) * 0.1
    dy = rng.standard_normal((Bt, S, nh, hd), np.float32)
    dh = rng.standard_normal((Bt, nh, hd, ds), np.float32)
    return (x, dt, A, Bm, Cm, h0), dy, dh


def _close_scaled(name, got, want, rel=REL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, name
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * float(np.abs(want).max()),
                               err_msg=name)


def _ref_grads(arrs, dy, dh, chunk):
    t = [torch.from_numpy(a) for a in (*arrs, dy, dh)]
    return ref.ssd_scan_bwd_ref(*t, chunk)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("case", list(CASES))
def test_bwd_ref_matches_jax_vjp(case, seed):
    Bt, S, nh, hd, ds, chunk, tail = CASES[case]
    arrs, dy, dh = _inputs(seed, Bt, S, nh, hd, ds, tail)
    _, vjp = jax.vjp(lambda *a: jmamba.ssd_chunked(*a, chunk),
                     *(jnp.asarray(a) for a in arrs))
    want = vjp((jnp.asarray(dy), jnp.asarray(dh)))
    got = _ref_grads(arrs, dy, dh, chunk)
    for name, g, w, a in zip(NAMES, got, want, arrs):
        assert g.dtype == torch.float32 and g.shape == a.shape, name
        _close_scaled(name, g.numpy(), w)
    if tail:              # the zero-dt rows inside S get no dx, but a ddt
        assert not got[0][:, S - tail:].any()
        assert got[1][:, S - tail:].abs().max() > 0


@pytest.mark.parametrize("case", list(CASES))
def test_bwd_ref_matches_autograd_of_the_plain_scan(case):
    Bt, S, nh, hd, ds, chunk, tail = CASES[case]
    arrs, dy, dh = _inputs(2, Bt, S, nh, hd, ds, tail)
    leaves = [torch.from_numpy(a).requires_grad_() for a in arrs]
    y, h = ref.ssd_scan_ref(*leaves, chunk)
    want = torch.autograd.grad((y, h), leaves, (torch.from_numpy(dy),
                                                torch.from_numpy(dh)))
    got = _ref_grads(arrs, dy, dh, chunk)
    for name, g, w in zip(NAMES, got, want):
        _close_scaled(name, g.numpy(), w.numpy())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bwd_ref_keeps_the_input_dtypes(dtype):
    """dx, dB and dC in their inputs' dtype, ddt, dA and dh0 in fp32, the
    bf16 ones the fp32 gradients rounded once."""
    arrs, dy, dh = _inputs(3, 1, 70, 2, 16, 16)
    t = [torch.from_numpy(a) for a in arrs]
    for i in (0, 3, 4):
        t[i] = t[i].to(dtype)
    got = ref.ssd_scan_bwd_ref(*t, torch.from_numpy(dy),
                               torch.from_numpy(dh), 64)
    assert [g.dtype for g in got] == [dtype, torch.float32, torch.float32,
                                      dtype, dtype, torch.float32]
    full = ref.ssd_scan_bwd_ref(*(a.float() for a in t),
                                torch.from_numpy(dy), torch.from_numpy(dh),
                                64)
    for i in (0, 3, 4):
        assert torch.equal(got[i], full[i].to(dtype))


# ------------------------------------------- the kernels' decomposition

def _kernel_steps(x, dt, A, B, C, h0, dy, dh, chunk):
    """The backward kernels' steps in float64, the ragged last chunk read
    in place (no padding): 1. each chunk's state S_k and the state
    gradient's chunk term D_k = dy^T (C e^cum); 2. H_in forward and dH_out
    back through the chunks, dh0; 3. per chunk, the carried state's terms
    of dC and dcum, then the dual form's tiles (dx, dB, dC, dcum's row and
    column sums, ddt's direct part), then the state update's terms, its
    sum and e^cum_last <dH_out, H_in> at the chunk's last valid row;
    4. the reverse cumsum of dcum into ddt and dA; 5. dB and dC summed
    over heads, dA over rows and chunks."""
    x, dt, A, B, C, h0, dy, dh = (np.asarray(a, np.float64) for a in
                                  (x, dt, A, B, C, h0, dy, dh))
    Bt, S, nh, hd = x.shape
    spans = [slice(t0, min(S, t0 + chunk)) for t0 in range(0, S, chunk)]
    cums, st, dst = [], [], []
    for sl in spans:                                            # 1
        cum = np.cumsum(dt[:, sl] * A, axis=1)                  # [Bt, n, nh]
        cums.append(cum)
        sc = dt[:, sl] * np.exp(cum[:, -1:] - cum)
        st.append(np.einsum("bjhd,bjs,bjh->bhds", x[:, sl], B[:, sl], sc))
        dst.append(np.einsum("bihd,bis,bih->bhds", dy[:, sl], C[:, sl],
                             np.exp(cum)))
    h, h_in = h0, []                                            # 2
    for cum, s_k in zip(cums, st):
        h_in.append(h)
        h = np.exp(cum[:, -1])[:, :, None, None] * h + s_k
    g, dh_out = dh, [None] * len(spans)
    for k in reversed(range(len(spans))):
        dh_out[k] = g
        g = np.exp(cums[k][:, -1])[:, :, None, None] * g + dst[k]
    dx = np.zeros_like(x)
    ddt = np.zeros_like(dt)
    dBh = np.zeros((Bt, nh) + B.shape[1:])
    dCh = np.zeros_like(dBh)
    dA = np.zeros((Bt, len(spans), nh))
    for k, (sl, cum) in enumerate(zip(spans, cums)):            # 3
        xk, dyk, dtk, Bk, Ck = x[:, sl], dy[:, sl], dt[:, sl], B[:, sl], \
            C[:, sl]
        n = cum.shape[1]
        ec = np.exp(cum)
        v = np.einsum("bhds,bihd->bhis", h_in[k], dyk)
        dC_k = ec.transpose(0, 2, 1)[..., None] * v
        pos = np.einsum("bih,bis,bhis->bih", ec, Ck, v)
        causal = np.tril(np.ones((n, n), bool))[None, :, :, None]
        L = np.exp(np.where(causal, cum[:, :, None] - cum[:, None], -np.inf))
        cb = np.einsum("bis,bjs->bij", Ck, Bk)[..., None]
        G = np.einsum("bihd,bjhd->bijh", dyk, xk)
        W, Q, K = cb * L * dtk[:, None], G * L * dtk[:, None], cb * G * L
        dx_k = np.einsum("bijh,bihd->bjhd", W, dyk)
        dB_k = np.einsum("bijh,bis->bhjs", Q, Ck)
        dC_k = dC_k + np.einsum("bijh,bjs->bhis", Q, Bk)
        pos = pos + np.einsum("bijh,bjh->bih", K, dtk)
        colK = K.sum(1)
        neg = dtk * colK
        dd = colK.copy()
        tl = np.exp(cum[:, -1:] - cum)
        f = dtk * tl
        u = np.einsum("bhds,bjs->bjhd", dh_out[k], Bk)
        sx = np.einsum("bjhd,bjhd->bjh", xk, u)
        dx_k = dx_k + f[..., None] * u
        dB_k = dB_k + np.einsum("bjh,bhds,bjhd->bhjs", f, dh_out[k], xk)
        dd = dd + tl * sx
        neg = neg + f * sx
        dcum = pos - neg
        dcum[:, -1] += (f * sx).sum(1) + np.exp(cum[:, -1]) \
            * (dh_out[k] * h_in[k]).sum((-2, -1))
        R = np.cumsum(dcum[:, ::-1], axis=1)[:, ::-1]            # 4
        ddt[:, sl] = dd + A * R
        dA[:, k] = (dtk * R).sum(1)
        dx[:, sl] = dx_k
        dBh[:, :, sl] = dB_k
        dCh[:, :, sl] = dC_k
    return dx, ddt, dA.sum((0, 1)), dBh.sum(1), dCh.sum(1), g     # 5


def _scan64(x, dt, A, B, C, h0, chunk):
    """The scan in float64 torch ops (the plain version's arithmetic, its
    ragged last chunk zero-padded), for autograd."""
    Bt, S, nh, hd = x.shape
    pad = (-S) % chunk
    if pad:
        x, dt, B, C = (torch.nn.functional.pad(a, (0, 0) * (a.dim() - 2)
                                               + (0, pad))
                       for a in (x, dt, B, C))
    ys, h = [], h0
    for t0 in range(0, x.shape[1], chunk):
        sl = slice(t0, t0 + chunk)
        xk, dtk, Bk, Ck = x[:, sl], dt[:, sl], B[:, sl], C[:, sl]
        cum = torch.cumsum(dtk * A, 1)
        causal = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool))
        li = cum[:, :, None] - cum[:, None]
        L = torch.where(causal[None, :, :, None],
                        torch.exp(torch.where(causal[None, :, :, None], li,
                                              0.0)), 0.0)
        w = torch.einsum("bis,bjs->bij", Ck, Bk)[..., None] * L \
            * dtk[:, None]
        ys.append(torch.einsum("bijh,bjhd->bihd", w, xk) + torch.einsum(
            "bis,bhds,bih->bihd", Ck, h, torch.exp(cum)))
        tail = torch.exp(cum[:, -1:] - cum)
        h = torch.exp(cum[:, -1])[:, :, None, None] * h + torch.einsum(
            "bjs,bjhd,bjh->bhds", Bk, xk, dtk * tail)
    return torch.cat(ys, 1)[:, :S], h


@pytest.mark.parametrize("case", ["ds16", "ragged", "one_chunk",
                                  "zero_dt_tail"])
def test_kernel_steps_in_float64_equal_the_gradient(case):
    """The kernels' steps in float64 against autograd of the scan in
    float64 (within 1e-10 of each gradient's largest magnitude: fp64
    rounding), the plain backward (fp64 inside, its outputs rounded to
    fp32) within 1e-6, and ``jax.vjp`` of ``ssd_chunked`` (f32) within
    ``REL``."""
    Bt, S, nh, hd, ds, chunk, tail = CASES[case]
    arrs, dy, dh = _inputs(4, Bt, S, nh, hd, ds, tail)
    got = _kernel_steps(*arrs, dy, dh, chunk)
    leaves = [torch.from_numpy(a).double().requires_grad_() for a in arrs]
    y, h = _scan64(*leaves, chunk)
    want = torch.autograd.grad((y, h), leaves, (
        torch.from_numpy(dy).double(), torch.from_numpy(dh).double()))
    for name, g, w in zip(NAMES, got, want):
        _close_scaled(name, g, w.numpy(), 1e-10)
    _, vjp = jax.vjp(lambda *a: jmamba.ssd_chunked(*a, chunk),
                     *(jnp.asarray(a) for a in arrs))
    for name, g, w in zip(NAMES, got, vjp((jnp.asarray(dy),
                                           jnp.asarray(dh)))):
        _close_scaled(name, g, w)
    for name, g, w in zip(NAMES, got, _ref_grads(arrs, dy, dh, chunk)):
        _close_scaled(name, g, w.numpy(), 1e-6)


# ---------------------------------------------------------------- the plan

@pytest.mark.parametrize("Bt,S,chunk,nh,hd,ds,want", [
    # mamba2-370m, one 1024-token row: 4 chunks of 4 tiles, 2 heads a dx
    # block, 4 a dB / dC block
    (1, 1024, 256, 32, 64, 128,
     dict(groups=(2, 4), state_grid=(8, 32, 1), pass_grid=(32, 32, 1),
          chunk_grid=(4, 16, 4), dbdc_grid=(8, 8, 4), dcum_grid=(4, 32, 1),
          reduce_grid=(1025,), group_partials=(1, 8, 1024, 128))),
    # a ragged last chunk, two rows
    (2, 700, 256, 32, 64, 128,
     dict(groups=(2, 4), state_grid=(6, 32, 2), pass_grid=(32, 32, 2),
          chunk_grid=(3, 16, 8), dbdc_grid=(6, 8, 8), dcum_grid=(3, 32, 2),
          reduce_grid=(1401,), group_partials=(2, 8, 700, 128))),
    # jamba-v0.1's d_state 16 at 128 heads
    (2, 1024, 256, 128, 64, 16,
     dict(groups=(2, 4), state_grid=(4, 128, 2), pass_grid=(4, 128, 2),
          chunk_grid=(4, 64, 8), dbdc_grid=(8, 32, 8), dcum_grid=(4, 128, 2),
          reduce_grid=(257,), group_partials=(2, 32, 1024, 16))),
    # head_dim 128: one head a dx block, two a dB / dC block
    (1, 300, 256, 4, 128, 128,
     dict(groups=(1, 2), state_grid=(8, 4, 1), pass_grid=(64, 4, 1),
          chunk_grid=(2, 4, 4), dbdc_grid=(4, 2, 4), dcum_grid=(2, 4, 1),
          reduce_grid=(301,), group_partials=(1, 2, 300, 128))),
    # small_100m's Mamba2 (24 heads, chunk 64): 8 rows of 128
    (8, 128, 64, 24, 64, 128,
     dict(groups=(2, 4), state_grid=(4, 24, 8), pass_grid=(32, 24, 8),
          chunk_grid=(2, 12, 8), dbdc_grid=(4, 6, 8), dcum_grid=(2, 24, 8),
          reduce_grid=(1025,), group_partials=(8, 6, 128, 128))),
    # head_dim 16, three heads: a group short of its four heads
    (2, 130, 64, 3, 16, 64,
     dict(groups=(4, 4), state_grid=(3, 3, 2), pass_grid=(4, 3, 2),
          chunk_grid=(3, 1, 2), dbdc_grid=(6, 1, 2), dcum_grid=(3, 3, 2),
          reduce_grid=(131,), group_partials=(2, 1, 130, 64))),
    # a chunk of 1024 at head_dim 16: four heads a block
    (1, 2048, 1024, 8, 16, 64,
     dict(groups=(4, 4), state_grid=(2, 8, 1), pass_grid=(4, 8, 1),
          chunk_grid=(2, 2, 16), dbdc_grid=(4, 2, 16), dcum_grid=(2, 8, 1),
          reduce_grid=(1025,), group_partials=(1, 2, 2048, 64))),
])
def test_ssd_scan_bwd_plan(Bt, S, chunk, nh, hd, ds, want):
    """The grids and scratch of the six kernels: the dx blocks hold the
    heads whose columns fill 128, the dB / dC blocks those that fill 256
    (at most 4), so the dB / dC partials are one a group, not one a head;
    dsum holds a slot a 64-row tile plus two, in fp64."""
    p = ssd.plan_bwd(Bt, S, chunk, nh, hd, ds)
    nc, nt = -(-S // chunk), chunk // ssd.TILE
    assert p["chunks"] == (nc,)
    for key, value in want.items():
        assert p[key] == value, key
    g3, g4 = p["groups"]
    assert g3 * hd <= ssd.DX_COLS and g4 * hd <= ssd.DBDC_COLS
    assert p["chunk_grid"] == (nc, -(-nh // g3), nt * Bt)
    assert p["states"] == p["dstates"] == (Bt, nc, nh, hd, ds)
    assert p["decay"] == p["da_partials"] == (Bt, nc, nh)
    assert p["dsum"] == (Bt, nc, nh, nt + 2, chunk)
    assert p["ddt_direct"] == (Bt, nc, nh, chunk)
    # the scratch of dB and dC is the per-head one shrunk by the group
    assert p["group_partials"] == (Bt, -(-nh // g4), S, ds)
    # the batch enters only along its axis
    one = ssd.plan_bwd(1, S, chunk, nh, hd, ds)
    for key in ("state_grid", "pass_grid", "dcum_grid"):
        assert p[key][:2] == one[key][:2] and p[key][2] == Bt
    for key in ("chunk_grid", "dbdc_grid"):
        assert p[key][:2] == one[key][:2] and p[key][2] == Bt * one[key][2]
    for key in ("states", "dstates", "decay", "dsum", "ddt_direct",
                "group_partials", "da_partials"):
        assert p[key] == (Bt,) + one[key][1:]


def _bwd_args(rng, Bt=1, S=64, nh=2, hd=32, ds=64, dtype=torch.float32):
    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32))
    return (t(Bt, S, nh, hd).to(dtype), t(Bt, S, nh).abs(), -t(nh).abs(),
            t(Bt, S, ds).to(dtype), t(Bt, S, ds).to(dtype),
            t(Bt, nh, hd, ds), t(Bt, S, nh, hd), t(Bt, nh, hd, ds))


def test_ssd_scan_bwd_wrapper_refuses_what_the_kernels_do_not_take():
    rng = np.random.default_rng(0)
    bwd = ssd.ssd_scan_bwd_cuda
    with pytest.raises(ValueError, match="d_state"):
        bwd(*_bwd_args(rng, ds=32), 64)
    with pytest.raises(ValueError, match="chunk"):
        bwd(*_bwd_args(rng), 32)                      # not 64k
    with pytest.raises(ValueError, match="chunk"):
        bwd(*_bwd_args(rng), 2048)                    # past 1024
    with pytest.raises(ValueError, match="head_dim"):
        bwd(*_bwd_args(rng, hd=24), 64)
    with pytest.raises(ValueError, match="head_dim 144 is past 128"):
        bwd(*_bwd_args(rng, hd=144), 64)
    x, dt, A, B, C, h0, dy, dh = _bwd_args(rng)
    with pytest.raises(TypeError, match="float32"):
        bwd(x, dt, A, B, C, h0, dy.to(torch.bfloat16), dh, 64)
    with pytest.raises(TypeError, match="float32"):
        bwd(x, dt, A, B, C, h0, dy, dh.double(), 64)
    with pytest.raises(TypeError, match="float32"):
        bwd(x, dt.to(torch.bfloat16), A, B, C, h0, dy, dh, 64)
    with pytest.raises(TypeError, match="dtype"):
        bwd(x.to(torch.bfloat16), dt, A, B, C, h0, dy, dh, 64)
    with pytest.raises(ValueError, match="backward: unsupported shapes"):
        bwd(x, dt, A, B, C, h0, dy[:, :-1], dh, 64)
    with pytest.raises(ValueError, match="backward: unsupported shapes"):
        bwd(x, dt, A, B, C, h0, dy, dh[..., :32], 64)
    # every rule above holds: the device is checked last
    with pytest.raises(ValueError, match="CUDA"):
        bwd(x, dt, A, B, C, h0, dy, dh, 64)


# ---------------------------------------------------------------- wiring

@pytest.fixture
def scan_route(monkeypatch):
    """``ops`` routed to the kernel wrappers, the two scan wrappers
    replaced by stubs that run the plain versions and record their
    calls: the kernel route's wiring, without a card."""
    calls = []

    def stub(name, fn):
        def run(*a, **kw):
            calls.append(name)
            return fn(*a, **kw)
        return run

    monkeypatch.setattr(ops, "_plain", lambda name, device: False)
    monkeypatch.setattr(ssd, "ssd_scan_cuda", stub("ssd_scan",
                                                   ref.ssd_scan_ref))
    monkeypatch.setattr(ssd, "ssd_scan_bwd_cuda", stub(
        "ssd_scan_bwd", ref.ssd_scan_bwd_ref))
    return calls


def _leaves(seed=5, Bt=2, S=100, nh=3, hd=16, ds=16):
    arrs, dy, dh = _inputs(seed, Bt, S, nh, hd, ds)
    return [torch.from_numpy(a) for a in arrs], torch.from_numpy(dy), \
        torch.from_numpy(dh)


def test_ssd_scan_kernel_route_runs_both_kernels(scan_route):
    """On the kernel route the Function's forward and backward are the
    two wrappers, once each, and its gradients the backward's."""
    t, dy, dh = _leaves()
    leaves = [a.clone().requires_grad_() for a in t]
    y, h = ops.ssd_scan(*leaves, chunk=64)
    grads = torch.autograd.grad((y, h), leaves, (dy, dh))
    assert scan_route == ["ssd_scan", "ssd_scan_bwd"]
    for g, w in zip(grads, ref.ssd_scan_bwd_ref(*t, dy, dh, 64)):
        assert torch.equal(g, w)


def test_ssd_scan_without_grad_is_the_plain_call(scan_route):
    """Grad mode off, or no input requiring a gradient: no Function, one
    forward call, the same bits."""
    t, _, _ = _leaves()
    want = ref.ssd_scan_ref(*t, 64)
    got = ops.ssd_scan(*t, chunk=64)
    x = t[0].clone().requires_grad_()
    with torch.no_grad():
        off = ops.ssd_scan(x, *t[1:], chunk=64)
    assert scan_route == ["ssd_scan", "ssd_scan"]
    for a, b, c in zip(got, off, want):
        assert a.grad_fn is None and b.grad_fn is None
        assert torch.equal(a, c) and torch.equal(b, c)


def test_ssd_scan_plain_route_counts_the_backward():
    """On the CPU both calls are the plain versions, counted as such."""
    t, dy, dh = _leaves()
    leaves = [a.clone().requires_grad_() for a in t]
    ops.reset_counts()
    y, h = ops.ssd_scan(*leaves, chunk=64)
    torch.autograd.grad((y, h), leaves, (dy, dh))
    c = ops.counts()
    assert c["ssd_scan"] == {"launches": 0, "plain": 1}
    assert c["ssd_scan_bwd"] == {"launches": 0, "plain": 1}


def test_gradients_reach_the_mixers_slices_and_parameters(scan_route):
    """x, B and C as strided slices of one projection get their gradients
    in place of the slices; dt and A through softplus and -exp(A_log) by
    autograd outside the kernel. Held to autograd of the plain scan within
    2e-4 of each gradient's largest magnitude: the model's decays (A to
    -16) take |cum| to ~700 in a chunk, where one ulp of cum is 6e-5, and
    A's gradient sums such terms, so the fp32 plain scan's autograd is
    itself that far from the fp64 backward."""
    Bt, S, nh, hd, ds, chunk = 2, 70, 3, 16, 16, 64
    rng = np.random.default_rng(7)
    xBC = torch.from_numpy(rng.standard_normal(
        (Bt, S, nh * hd + 2 * ds), np.float32)).requires_grad_()
    raw = torch.from_numpy(rng.standard_normal((Bt, S, nh), np.float32))
    dt_bias = torch.zeros(nh, requires_grad=True)
    A_log = torch.from_numpy(np.log(np.linspace(1, 16, nh)).astype(
        np.float32)).requires_grad_()
    h0 = torch.zeros(Bt, nh, hd, ds)
    d_in = nh * hd

    def run(scan, xBC, dt_bias, A_log):
        x = xBC[..., :d_in].reshape(Bt, S, nh, hd)
        B, C = xBC[..., d_in:d_in + ds], xBC[..., d_in + ds:]
        dt = torch.nn.functional.softplus(raw + dt_bias)
        return scan(x, dt, -torch.exp(A_log), B, C, h0, chunk=chunk)

    dy = torch.from_numpy(rng.standard_normal((Bt, S, nh, hd), np.float32))
    y, _ = run(ops.ssd_scan, xBC, dt_bias, A_log)
    got = torch.autograd.grad(y, (xBC, dt_bias, A_log), dy)
    assert scan_route == ["ssd_scan", "ssd_scan_bwd"]
    # the plain scan differentiated by autograd, for comparison
    leaves = [a.detach().clone().requires_grad_()
              for a in (xBC, dt_bias, A_log)]
    y2, _ = run(lambda *a, chunk: ref.ssd_scan_ref(*a, chunk), *leaves)
    want = torch.autograd.grad(y2, leaves, dy)
    for name, g, w in zip(("xBC", "dt_bias", "A_log"), got, want):
        assert g.abs().max() > 0, name
        _close_scaled(name, g.numpy(), w.numpy(), 2e-4)
