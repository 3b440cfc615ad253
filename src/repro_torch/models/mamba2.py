"""The Mamba2 (SSD, state-space duality) mixer, in PyTorch.

Counterpart of the JAX package's ``models/mamba2.py``: ``MambaState``,
``init_mamba_params``, ``init_mamba_state``, ``_gated_rmsnorm``,
``_project``, ``ssd_chunked``, ``mamba_forward`` and ``mamba_step`` keep
their names, their parameter layouts (``w_z [d, d_in]``, ``w_xBC [d,
conv_dim]``, ``w_dt [d, nh]``, ``conv_w [d_conv, conv_dim]``, ``conv_b``,
``A_log``, ``D``, ``dt_bias``, ``norm_w``, ``out_proj [d_in, d]``) and
their arithmetic. The chunked scan goes through ``kernels.ops.ssd_scan``:
the CUDA kernel for tensors on the card, the plain version on the CPU.

Two choices of form, not of result: the depthwise causal convolution is
written as its ``d_conv`` shifted products (JAX's
``lax.conv_general_dilated`` is a cross-correlation; products need no
cuDNN, so no TF32 either, and give each position the same bits whatever
the sequence length), and softplus is ``logaddexp(x, 0)``, as
``jax.nn.softplus`` is (``F.softplus`` turns into the identity above 20),
in JAX's own form ``max(x, 0) + log1p(exp(-|x|))``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.kernels import ops

from .config import ModelConfig


class MambaState(NamedTuple):
    conv: torch.Tensor    # [B, d_conv - 1, conv_dim]
    ssm: torch.Tensor     # [B, nh, hd, d_state] fp32


def _dims(cfg: ModelConfig):
    s = cfg.ssm
    d_in = s.d_inner(cfg.d_model)
    return s, d_in, s.n_heads(cfg.d_model), d_in + 2 * s.d_state


class Mamba(nn.Module):
    """The mixer's parameters, named and shaped as the JAX tree's
    ``init_mamba_params`` leaves (three separate input projections)."""

    def __init__(self, cfg: ModelConfig, device, dtype):
        super().__init__()
        s, d_in, nh, conv_dim = _dims(cfg)
        d = cfg.d_model

        def param(*shape):
            return nn.Parameter(torch.empty(shape, device=device,
                                            dtype=dtype),
                                requires_grad=False)
        self.w_z = param(d, d_in)
        self.w_xBC = param(d, conv_dim)
        self.w_dt = param(d, nh)
        self.conv_w = param(s.d_conv, conv_dim)
        self.conv_b = param(conv_dim)
        self.A_log = param(nh)
        self.D = param(nh)
        self.dt_bias = param(nh)
        self.norm_w = param(d_in)
        self.out_proj = param(d_in, d)


@torch.no_grad()
def init_mamba_params(p: Mamba, cfg: ModelConfig,
                      generator: torch.Generator) -> None:
    """Fill ``p`` in place with the JAX ``init_mamba_params`` values:
    normal draws scaled by ``d_model^-1/2`` (``w_z``, ``w_xBC``,
    ``w_dt``), ``0.1`` (``conv_w``) and ``d_in^-1/2`` (``out_proj``);
    ``A_log = log(linspace(1, 16, nh))``, ``D`` ones, ``conv_b``,
    ``dt_bias`` and ``norm_w`` zeros. The draws come from ``generator``;
    they are not JAX's numbers."""
    _, d_in, nh, _ = _dims(cfg)
    dev = p.w_z.device
    for name, std in (("w_z", cfg.d_model ** -0.5),
                      ("w_xBC", cfg.d_model ** -0.5),
                      ("w_dt", cfg.d_model ** -0.5), ("conv_w", 0.1),
                      ("out_proj", d_in ** -0.5)):
        w = getattr(p, name)
        w.copy_(torch.randn(w.shape, generator=generator, device=dev) * std)
    p.A_log.copy_(torch.log(torch.linspace(1.0, 16.0, nh, device=dev)))
    p.D.fill_(1.0)
    for w in (p.conv_b, p.dt_bias, p.norm_w):
        w.zero_()


def init_mamba_state(batch: int, cfg: ModelConfig, dtype=torch.float32,
                     device="cuda") -> MambaState:
    """Zeroed conv windows (in ``dtype``) and fp32 SSM states for
    ``batch`` rows on ``device``; raises without a card unless
    ``device="cpu"``."""
    s, _, nh, conv_dim = _dims(cfg)
    device = resolve_device(device)
    return MambaState(
        conv=torch.zeros((batch, s.d_conv - 1, conv_dim), dtype=dtype,
                         device=device),
        ssm=torch.zeros((batch, nh, s.headdim, s.d_state),
                        dtype=torch.float32, device=device))


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``logaddexp(x, 0)`` as JAX computes it: ``max(x, 0) +
    log1p(exp(-|x|))``. Written out because ``torch.logaddexp`` and
    ``F.softplus`` on the CPU round the tail of a vectorised loop
    differently from its body, so a position's bits would depend on the
    sequence length."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))


def _gated_rmsnorm(y, z, w, eps):
    y = y * torch.nn.functional.silu(z.float())
    v = y * torch.rsqrt(torch.mean(y * y, dim=-1, keepdim=True) + eps)
    return v * (1.0 + w.float())


def _project(p: Mamba, x):
    """x: [..., d_model] -> (z, xBC, dt) via the three separate weights."""
    return x @ p.w_z, x @ p.w_xBC, x @ p.w_dt


def ssd_chunked(x, dt, A, B, C, init_state, chunk: int):
    """The chunked SSD scan (``kernels.ops.ssd_scan``). x: [Bt, S, nh, hd];
    dt: [Bt, S, nh] (post-softplus); A: [nh] (negative); B, C:
    [Bt, S, d_state]; init_state: [Bt, nh, hd, d_state] fp32. Returns
    (y [Bt, S, nh, hd] fp32, final_state)."""
    return ops.ssd_scan(x, dt, A, B, C, init_state, chunk=chunk)


def mamba_forward(p: Mamba, x, cfg: ModelConfig, state: MambaState,
                  seq_lens=None):
    """Process a token block (a prefill chunk). x: [B, S, d_model].
    Returns (out [B, S, d_model], new_state).

    ``seq_lens`` ([B] int32, optional) marks each row's true length for
    rows padded at the tail: pad tokens get ``dt == 0`` after softplus,
    which leaves the state unchanged, and the carried conv state is
    gathered at each row's true end. A row's real-token outputs and final
    state are then bit-identical to an exact-length call."""
    s, d_in, nh, _ = _dims(cfg)
    Bt, S, _ = x.shape
    z, xBC, dt = _project(p, x)

    # causal depthwise conv with carried state: out[t] = sum_w
    # full[t + w] * conv_w[w], the cross-correlation over the window
    # ending at token t
    full = torch.cat([state.conv.to(xBC.dtype), xBC], dim=1)
    k = s.d_conv
    if seq_lens is not None and k > 1:
        idx = seq_lens.long()[:, None] + torch.arange(k - 1,
                                                      device=x.device)
        new_conv = torch.gather(
            full, 1, idx[..., None].expand(-1, -1, full.shape[-1]))
    elif k > 1:
        new_conv = full[:, -(k - 1):]
    else:
        new_conv = state.conv
    w = p.conv_w.to(full.dtype)
    conv_out = full[:, 0:S] * w[0]
    for i in range(1, k):
        conv_out = conv_out + full[:, i:i + S] * w[i]
    xBC = torch.nn.functional.silu(conv_out + p.conv_b)

    x_ssm = xBC[..., :d_in].reshape(Bt, S, nh, s.headdim)
    Bm = xBC[..., d_in:d_in + s.d_state]
    Cm = xBC[..., d_in + s.d_state:]
    dt = _softplus(dt.float() + p.dt_bias.float())
    if seq_lens is not None:
        valid = torch.arange(S, device=x.device)[None, :] \
            < seq_lens[:, None]
        dt = torch.where(valid[..., None], dt, 0.0)
    A = -torch.exp(p.A_log.float())

    y, new_ssm = ssd_chunked(x_ssm, dt, A, Bm, Cm, state.ssm, s.chunk)
    y = y + p.D.float()[None, None, :, None] * x_ssm.float()
    y = y.reshape(Bt, S, d_in)
    y = _gated_rmsnorm(y, z, p.norm_w, cfg.norm_eps)
    out = y.to(x.dtype) @ p.out_proj
    return out, MambaState(conv=new_conv, ssm=new_ssm)


def mamba_step(p: Mamba, x, cfg: ModelConfig, state: MambaState):
    """Single-token decode step, O(1) in context. x: [B, 1, d_model].
    Returns (out [B, 1, d_model], new_state)."""
    s, d_in, nh, _ = _dims(cfg)
    Bt = x.shape[0]
    z, xBC, dt = _project(p, x[:, 0])                 # [B, ...] each

    window = torch.cat([state.conv.to(xBC.dtype), xBC[:, None, :]], dim=1)
    conv_out = torch.einsum("bwc,wc->bc", window, p.conv_w.to(window.dtype))
    xBC = torch.nn.functional.silu(conv_out + p.conv_b)
    new_conv = window[:, 1:]

    x_ssm = xBC[..., :d_in].reshape(Bt, nh, s.headdim).float()
    Bm = xBC[..., d_in:d_in + s.d_state].float()
    Cm = xBC[..., d_in + s.d_state:].float()
    dt = _softplus(dt.float() + p.dt_bias.float())    # [B, nh]
    A = -torch.exp(p.A_log.float())

    dec = torch.exp(dt * A[None, :])                  # [B, nh]
    h = dec[:, :, None, None] * state.ssm \
        + torch.einsum("bs,bhd,bh->bhds", Bm, x_ssm, dt)
    y = torch.einsum("bs,bhds->bhd", Cm, h)
    y = y + p.D.float()[None, :, None] * x_ssm
    y = y.reshape(Bt, d_in)
    y = _gated_rmsnorm(y, z, p.norm_w, cfg.norm_eps)
    out = y.to(x.dtype) @ p.out_proj
    return out[:, None, :], MambaState(conv=new_conv, ssm=h)
