"""Plain PyTorch versions of the kernels.

The simplest correct implementation of each function (a gather and a
naive masked softmax in fp32 for attention; the norm's fp32 arithmetic
and its gradient; the chunked SSD scan as ``ssd_chunked`` computes it,
and its gradient in fp64),
written apart from
the CUDA kernels so that agreement between the two means something. The
CPU path of ``kernels.ops`` runs them, the tests hold them against the
JAX package's ``kernels/ref.py``, its Pallas kernels and
``models/mamba2.py::ssd_chunked``, and ``chip_smoke.py`` holds the CUDA
kernels against them on the card.

Unlike the JAX oracles (softmax over ``-inf``), a row with nothing
visible gives zeros here, as the Pallas kernels and the model's masked
softmax do: the engine's pad rows and inactive decode slots are such
rows, and their outputs must stay finite.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

NEG_INF = -1e30


def _softmax_masked(scores: torch.Tensor, mask: torch.Tensor):
    """Softmax over the last axis where ``mask`` holds; a row with
    nothing visible gives zeros, not NaN."""
    scores = torch.where(mask, scores, NEG_INF)
    m = torch.amax(scores, dim=-1, keepdim=True).clamp_min(-1e29)
    e = torch.where(mask, torch.exp(scores - m), 0.0)
    s = torch.sum(e, dim=-1, keepdim=True)
    return e / s.clamp_min(1e-30)


def _per_row(x, batch: int, device) -> torch.Tensor:
    """An int or a ``[B]`` tensor as a ``[B, 1]`` int64 column."""
    t = torch.as_tensor(x, device=device).to(torch.int64).reshape(-1, 1)
    return t.expand(batch, 1)


def chunked_prefill_attention_ref(q, k, v, q_offset, kv_len, window=None):
    """q: [B, C, H, D] chunk queries at positions ``q_offset + i``.
    k, v: [B, S, KV, D] cache buffer (the first ``kv_len`` rows valid,
    the chunk included). ``q_offset`` and ``kv_len`` are ints (the JAX
    static mode) or ``[B]`` tensors (per-row, the dynamic mode).
    Returns [B, C, H, D]."""
    B, C, H, D = q.shape
    S, KV = k.shape[1], k.shape[2]
    G = H // KV
    dev = q.device
    qf = q.reshape(B, C, KV, G, D).float()
    s = torch.einsum("bqkgd,bskd->bkgqs", qf, k.float()) * D ** -0.5
    qpos = _per_row(q_offset, B, dev) + torch.arange(C, device=dev)  # [B, C]
    kpos = torch.arange(S, device=dev)
    mask = (kpos[None, None, :] <= qpos[:, :, None]) \
        & (kpos[None, None, :] < _per_row(kv_len, B, dev)[:, :, None])
    if window is not None:
        mask = mask & (qpos[:, :, None] - kpos[None, None, :] < window)
    p = _softmax_masked(s, mask[:, None, None])               # [B,KV,G,C,S]
    o = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    return o.reshape(B, C, H, D).to(q.dtype)


def paged_attention_ref(q, k_pages, v_pages, block_table, lens,
                        k_scales=None, v_scales=None):
    """Decode attention over a paged KV cache.

    q: [B, H, D]; k_pages/v_pages: [P, page, KV, D];
    block_table: [B, n_pages] int32 (page ids, -1 pad); lens: [B] int32.
    With ``k_scales``/``v_scales`` ([P, page, KV], bf16) the pages are
    int8 and each element reads as ``f32(k8) * f32(scale)``, exact in
    fp32 and never rounded to bf16, as the JAX int8 kernel dequantizes.
    Returns [B, H, D]."""
    B, H, D = q.shape
    _, page, KV, _ = k_pages.shape
    G = H // KV
    n_pages = block_table.shape[1]
    safe = block_table.clamp_min(0).long()
    k = k_pages[safe].reshape(B, n_pages * page, KV, D).float()
    v = v_pages[safe].reshape(B, n_pages * page, KV, D).float()
    if k_scales is not None:
        k = k * k_scales[safe].reshape(B, n_pages * page, KV, 1).float()
        v = v * v_scales[safe].reshape(B, n_pages * page, KV, 1).float()
    pos = torch.arange(n_pages * page, device=q.device)
    valid = (pos[None, :] < lens[:, None]) \
        & (block_table >= 0).repeat_interleave(page, dim=1)
    qf = q.reshape(B, KV, G, D).float()
    s = torch.einsum("bkgd,bskd->bkgs", qf, k) * D ** -0.5
    p = _softmax_masked(s, valid[:, None, None, :])
    o = torch.einsum("bkgs,bskd->bkgd", p, v)
    return o.reshape(B, H, D).to(q.dtype)


def rmsnorm_ref(x, w, eps: float = 1e-5):
    """``x * rsqrt(mean(x^2) + eps) * (1 + w)`` over the last axis, in
    fp32, cast back to ``x.dtype``: the arithmetic of the JAX package's
    ``models/layers.py::rmsnorm``."""
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * (1.0 + w.float())).to(dt)


def rmsnorm_bwd_ref(x, w, dy, eps: float = 1e-5):
    """The gradient of ``rmsnorm_ref`` written out in fp32: with ``r =
    rsqrt(mean(x^2) + eps)`` and ``u = dy * (1 + w)`` over the last axis,
    ``dx = r * u - x * r^3 * mean(u * x)`` and ``dw = sum over rows of
    dy * x * r``. Returns (dx in x's dtype, dw [D] fp32)."""
    xf, dyf = x.float(), dy.float()
    r = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    u = dyf * (1.0 + w.float())
    dx = r * u - xf * (r * r * r * torch.mean(u * xf, dim=-1, keepdim=True))
    dw = torch.sum((dyf * xf * r).reshape(-1, x.shape[-1]), dim=0)
    return dx.to(x.dtype), dw


def ssd_scan_ref(x, dt, A, B_, C_, init_state, chunk: int):
    """The Mamba2 chunked SSD scan, as the JAX package's
    ``models/mamba2.py::ssd_chunked`` computes it: zero-pad ``S`` to the
    chunk grid, cumulative decay within each chunk, the intra-chunk dual
    form ``(C B^T) * L * dt`` with ``L = exp(cum_i - cum_j)`` masked to
    ``j <= i`` before the exp, plus the carried state's term, then the
    state update; chunks run in order.

    x: [Bt, S, nh, hd]; dt: [Bt, S, nh] (post-softplus); A: [nh]
    (negative); B_, C_: [Bt, S, ds] (one group); init_state:
    [Bt, nh, hd, ds]. Returns (y [Bt, S, nh, hd] fp32, final state
    [Bt, nh, hd, ds] fp32)."""
    Bt, S, nh, hd = x.shape
    ds = B_.shape[-1]
    pad = (-S) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B_ = F.pad(B_, (0, 0, 0, pad))
        C_ = F.pad(C_, (0, 0, 0, pad))
    n = x.shape[1] // chunk
    xc = x.reshape(Bt, n, chunk, nh, hd).float()
    dtc = dt.reshape(Bt, n, chunk, nh).float()
    Bc = B_.reshape(Bt, n, chunk, ds).float()
    Cc = C_.reshape(Bt, n, chunk, ds).float()
    cum = torch.cumsum(dtc * A.float()[None, None, None, :], dim=2)
    causal = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool,
                                   device=x.device))[None, :, :, None]
    h = init_state.float()
    ys = []
    for k in range(n):
        xk, dtk, Bk, Ck, cumk = (xc[:, k], dtc[:, k], Bc[:, k], Cc[:, k],
                                 cum[:, k])
        li = cumk[:, :, None, :] - cumk[:, None, :, :]      # [Bt,c,c,nh]
        Lmat = torch.where(causal, torch.exp(torch.where(causal, li, 0.0)),
                           0.0)
        cb = torch.einsum("bis,bjs->bij", Ck, Bk)
        w = cb[..., None] * Lmat * dtk[:, None, :, :]
        y_intra = torch.einsum("bijh,bjhd->bihd", w, xk)
        y_inter = torch.einsum("bis,bhds,bih->bihd", Ck, h, torch.exp(cumk))
        tail = torch.exp(cumk[:, -1:, :] - cumk)              # [Bt,c,nh]
        upd = torch.einsum("bjs,bjhd,bjh,bjh->bhds", Bk, xk, dtk, tail)
        h = torch.exp(cumk[:, -1, :])[:, :, None, None] * h + upd
        ys.append(y_intra + y_inter)
    y = torch.stack(ys, dim=1).reshape(Bt, n * chunk, nh, hd)
    return y[:, :S], h


def ssd_scan_bwd_ref(x, dt, A, B_, C_, init_state, dy, dh, chunk: int):
    """The gradient of ``ssd_scan_ref`` for the output gradients ``dy``
    ([Bt, S, nh, hd]) and ``dh`` ([Bt, nh, hd, ds], the final state's),
    written out as the chunked decomposition the backward kernels follow
    (the Mamba2 paper's SSD, arXiv:2405.21060 sections 6-7; the public
    ``mamba_ssm`` SSD backward splits the same terms into its chunk-scan,
    chunk-state and state-passing backward kernels), not as autograd of
    the forward. In fp64, the outputs rounded to fp32 and then to their
    dtype: two fp32 versions of this gradient disagree by up to ~5e-4 of
    the decay parameters' largest gradient where the decay is steep
    (``cum`` reaches ~3e3 within a chunk, where one fp32 ulp of it is
    2.4e-4, and ``dcum``'s row and column sums cancel in its reverse
    cumsum); the backward kernels difference the decay compensated and
    sum dcum in fp64, so their yardstick computes in fp64. Per chunk k,
    with ``cum`` the within-chunk cumulative sum of ``dt A``, ``L_ij =
    exp(cum_i - cum_j)`` for ``j <= i`` (masked before the exp) and
    ``CB_ij = C_i . B_j``:

    1. the state entering each chunk, ``H_in_k``, recomputed forward;
    2. a reverse pass over the chunks: ``dH_in_k = exp(cum_last) dH_out_k
       + sum_i exp(cum_i) dy_i C_i^T``, where the last chunk's ``dH_out``
       is ``dh``, ``dH_out_{k-1} = dH_in_k`` and ``dh0 = dH_in_0``;
    3. per chunk, the dual form: with ``G_ij = dy_i . x_j``,
       ``dx_j = dt_j [sum_{i>=j} CB_ij L_ij dy_i + exp(cum_last - cum_j)
       dH_out B_j]``; ``dB_j`` and ``dC_i`` (summed over heads) from
       ``Q_ij = G_ij L_ij dt_j``, ``exp(cum_i) H_in^T dy_i`` and
       ``exp(cum_last - cum_j) dt_j dH_out^T x_j``; the direct ``ddt_j`` of
       the dual form and of the state update;
    4. ``dcum``: the row sum minus the column sum of ``CB_ij L_ij dt_j
       G_ij``, plus the carried state's term ``exp(cum_i) C_i . H_in^T
       dy_i``, minus each row's share of the state update, whose sum (and
       ``exp(cum_last) <dH_out, H_in>``) goes to the chunk's last row;
    5. the reverse within-chunk cumsum ``R_t = sum_{i>=t} dcum_i``:
       ``ddt_t += A R_t`` and ``dA = sum dt_t R_t``.

    ``S`` is zero-padded to the chunk grid as in the forward; rows past
    ``S`` get no gradient. Returns (dx, ddt, dA, dB, dC, dh0): each its
    input's shape, dx, dB and dC in their input's dtype, ddt, dA and dh0
    fp32."""
    Bt, S, nh, hd = x.shape
    ds = B_.shape[-1]
    xdt, bdt, cdt = x.dtype, B_.dtype, C_.dtype
    pad = (-S) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dy = F.pad(dy, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B_ = F.pad(B_, (0, 0, 0, pad))
        C_ = F.pad(C_, (0, 0, 0, pad))
    n = x.shape[1] // chunk
    xc = x.reshape(Bt, n, chunk, nh, hd).double()
    dyc = dy.reshape(Bt, n, chunk, nh, hd).double()
    dtc = dt.reshape(Bt, n, chunk, nh).double()
    Bc = B_.reshape(Bt, n, chunk, ds).double()
    Cc = C_.reshape(Bt, n, chunk, ds).double()
    Af = A.double()
    cum = torch.cumsum(dtc * Af[None, None, None, :], dim=2)
    last = cum[:, :, -1]                                   # [Bt, n, nh]
    tail = torch.exp(last[:, :, None] - cum)               # [Bt, n, c, nh]
    ecum = torch.exp(cum)
    causal = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool,
                                   device=x.device))[None, :, :, None]

    # 1. the state entering each chunk
    h = init_state.double()
    h_in = []
    for k in range(n):
        h_in.append(h)
        upd = torch.einsum("bjs,bjhd,bjh,bjh->bhds", Bc[:, k], xc[:, k],
                           dtc[:, k], tail[:, k])
        h = torch.exp(last[:, k])[:, :, None, None] * h + upd
    # 2. the state's gradient, chunks in reverse
    g = dh.double()
    dh_out = [None] * n
    for k in reversed(range(n)):
        dh_out[k] = g
        g = torch.exp(last[:, k])[:, :, None, None] * g + torch.einsum(
            "bih,bihd,bis->bhds", ecum[:, k], dyc[:, k], Cc[:, k])
    dh0 = g

    dxs, ddts, dBs, dCs = [], [], [], []
    dA = torch.zeros_like(Af)
    for k in range(n):
        xk, dyk, dtk, Bk, Ck, cumk = (xc[:, k], dyc[:, k], dtc[:, k],
                                      Bc[:, k], Cc[:, k], cum[:, k])
        tk, ek, hk, gk = tail[:, k], ecum[:, k], h_in[k], dh_out[k]
        li = cumk[:, :, None, :] - cumk[:, None, :, :]      # [Bt,i,j,nh]
        Lmat = torch.where(causal, torch.exp(torch.where(causal, li, 0.0)),
                           0.0)
        cb = torch.einsum("bis,bjs->bij", Ck, Bk)[..., None]
        G = torch.einsum("bihd,bjhd->bijh", dyk, xk)
        Kmat = cb * G * Lmat                                # CB L G
        Q = G * Lmat * dtk[:, None]                         # G L dt_j
        # 3. the dual form's and the state update's direct terms
        u = torch.einsum("bhds,bjs->bjhd", gk, Bk)          # dH_out B_j
        su = torch.einsum("bjhd,bjhd->bjh", xk, u) * tk     # per row j
        dx = torch.einsum("bijh,bihd->bjhd", cb * Lmat * dtk[:, None], dyk) \
            + (dtk * tk)[..., None] * u
        ddt = Kmat.sum(1) + su
        dB = torch.einsum("bijh,bis->bjs", Q, Ck) + torch.einsum(
            "bjh,bhds,bjhd->bjs", dtk * tk, gk, xk)
        v = torch.einsum("bhds,bihd->bihs", hk, dyk)        # H_in^T dy_i
        dC = torch.einsum("bijh,bjs->bis", Q, Bk) \
            + torch.einsum("bih,bihs->bis", ek, v)
        # 4. dcum
        dcum = (Kmat * dtk[:, None]).sum(2) - dtk * Kmat.sum(1) \
            + ek * torch.einsum("bis,bihs->bih", Ck, v) - dtk * su
        dcum[:, -1] += (dtk * su).sum(1) + torch.exp(cumk[:, -1]) \
            * (gk * hk).sum((-2, -1))
        # 5. the reverse within-chunk cumsum
        R = torch.flip(torch.cumsum(torch.flip(dcum, [1]), 1), [1])
        ddts.append(ddt + Af * R)
        dA = dA + (dtk * R).sum((0, 1))
        dxs.append(dx)
        dBs.append(dB)
        dCs.append(dC)
    dx = torch.stack(dxs, 1).reshape(Bt, n * chunk, nh, hd)[:, :S]
    ddt = torch.stack(ddts, 1).reshape(Bt, n * chunk, nh)[:, :S]
    dB = torch.stack(dBs, 1).reshape(Bt, n * chunk, ds)[:, :S]
    dC = torch.stack(dCs, 1).reshape(Bt, n * chunk, ds)[:, :S]
    return (dx.float().to(xdt), ddt.float(), dA.float(),
            dB.float().to(bdt), dC.float().to(cdt), dh0.float())
