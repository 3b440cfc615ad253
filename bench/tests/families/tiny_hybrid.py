"""A hybrid family that exists only in the tests' temporary checkouts
(``conftest.write_root`` copies it to ``bench/reference/``): layers of
a Mamba2 mixer or causal attention, each followed by a routed, a dense
or no FFN, as the file's ``model.layers`` lists them (``[mixer, ffn]``).

The Mamba2 mixer is written plainly, in float32, from the published
description at one group of B and C (``n_groups`` 1) and with the
program's leaves (``w_z [d, d_in]``, ``w_xBC [d, d_in + 2 N]``, ``w_dt
[d, nh]``, ``conv_w [d_conv, conv_dim]``, ``conv_b``, ``A_log``, ``D``,
``dt_bias``, ``norm_w`` (the gain less one), ``out_proj [d_in, d]``):
the causal depthwise convolution of ``x B C`` over ``d_conv`` tokens
with its bias, then SiLU; ``dt = softplus(x w_dt + dt_bias)``, ``A =
-exp(A_log)``; the recurrence ``h_t = exp(dt_t A) h_{t-1} + dt_t x_t
B_t^T`` run token by token, ``y_t = h_t C_t + D x_t``; the RMSNorm of
``y * silu(z)`` over the whole ``d_in``; the output projection.
Attention and the FFNs are the decoder family's (``reference/
decoder.py``), and so are the fp8 control and the logits.
"""
from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Sequence, Tuple

import torch
import torch.nn.functional as F

from reference import decoder


def _ssm(m: dict):
    s = m["ssm"]
    d_in = s["expand"] * m["d_model"]
    nh = d_in // s["headdim"]
    return s, d_in, nh, d_in + 2 * s["d_state"]


def _dense(m: dict) -> dict:
    return dict(m, moe=None)


def layer_leaves(m: dict, li: int) -> List[tuple]:
    mixer, ffn = m["layers"][li][:2]
    d, p = m["d_model"], f"layers.{li}."
    dec = decoder.layer_leaves(_dense(m) if ffn != "moe" else m, li)
    out = [dec[0]]                                   # norm1
    if mixer == "mamba":
        s, d_in, nh, conv_dim = _ssm(m)
        out += [(p + "mamba.w_z", (d, d_in), d ** -0.5),
                (p + "mamba.w_xBC", (d, conv_dim), d ** -0.5),
                (p + "mamba.w_dt", (d, nh), d ** -0.5),
                (p + "mamba.conv_w", (s["d_conv"], conv_dim),
                 s["d_conv"] ** -0.5),
                (p + "mamba.conv_b", (conv_dim,), 0.1),
                (p + "mamba.A_log", (nh,), 0.5, 1.4),
                (p + "mamba.D", (nh,), 0.1, 1.0),
                (p + "mamba.dt_bias", (nh,), 0.5, -3.0),
                (p + "mamba.norm_w", (d_in,), 0.0),
                (p + "mamba.out_proj", (d_in, d), d_in ** -0.5)]
    else:
        out += dec[1:5]                              # attn.*
    if ffn != "none":
        out += dec[5:]                               # norm2, ffn or moe
    return out


def kv_layers(m: dict) -> int:
    return sum(mixer != "mamba" for mixer, *_ in m["layers"])


def step_flops(m: dict, chunks: Iterable[Tuple[int, int]],
               ctxs: Iterable[int], sampled: int) -> float:
    """The decoder's count, layer by layer: attention layers count their
    projections and visible keys, Mamba layers their projections, the
    convolution and the recurrence's two products a token."""
    chunks, ctxs = list(chunks), list(ctxs)
    d, H, KV, hd = m["d_model"], m["num_heads"], m["num_kv_heads"], \
        m["head_dim"]
    tokens = sum(r for _, r in chunks) + len(ctxs)
    pairs = sum(r * s + r * (r + 1) // 2 for s, r in chunks) + sum(ctxs)
    flops = sampled * 2.0 * d * m["vocab_size"]
    for mixer, ffn, *_ in m["layers"]:
        if mixer == "mamba":
            s, d_in, nh, conv_dim = _ssm(m)
            flops += tokens * (2.0 * d * (d_in + conv_dim + nh)
                               + 2.0 * s["d_conv"] * conv_dim
                               + 4.0 * d_in * s["d_state"]
                               + 2.0 * d_in * d)
        else:
            flops += tokens * 2.0 * (2 * d * H * hd + 2 * d * KV * hd) \
                + 4.0 * H * hd * pairs
        if ffn == "moe":
            moe = m["moe"]
            flops += tokens * (2.0 * d * moe["num_experts"] + moe["top_k"]
                               * 6.0 * d * moe["d_ff_expert"])
        elif ffn == "dense":
            flops += tokens * 6.0 * d * m["d_ff"]
    return flops


def mamba(m: dict, p: Dict[str, torch.Tensor], pre: str, h: torch.Tensor,
          lin: decoder.Linear) -> torch.Tensor:
    """One sequence's Mamba2 mixer: h [S, d] -> [S, d]."""
    s, d_in, nh, _ = _ssm(m)
    S, k, N = h.shape[0], s["d_conv"], s["d_state"]
    q = pre + "mamba."
    z, xbc, dt = (lin(h, p[q + n]) for n in ("w_z", "w_xBC", "w_dt"))
    xp = F.pad(xbc, (0, 0, k - 1, 0))
    conv = sum(xp[i:i + S] * p[q + "conv_w"][i] for i in range(k))
    xbc = F.silu(conv + p[q + "conv_b"])
    x = xbc[:, :d_in].reshape(S, nh, s["headdim"])
    B, C = xbc[:, d_in:d_in + N], xbc[:, d_in + N:]
    dt = F.softplus(dt + p[q + "dt_bias"])                 # [S, nh]
    A = -torch.exp(p[q + "A_log"])
    state = h.new_zeros(nh, s["headdim"], N)
    ys = []
    for t in range(S):
        state = torch.exp(dt[t] * A)[:, None, None] * state \
            + dt[t][:, None, None] * x[t][:, :, None] * B[t]
        ys.append(state @ C[t] + p[q + "D"][:, None] * x[t])
    y = torch.stack(ys).reshape(S, d_in) * F.silu(z)
    y = decoder.rmsnorm(y, p[q + "norm_w"], m["norm_eps"])
    return lin(y, p[q + "out_proj"])


def final_hidden(m: dict, get: Callable[[int], Dict[str, torch.Tensor]],
                 seqs: Sequence[torch.Tensor], keep: Sequence[torch.Tensor],
                 precision: str = "fp32") -> List[torch.Tensor]:
    lin = decoder.Linear(precision)
    eps, L = m["norm_eps"], m["num_layers"]
    emb = get(0)["embed"]
    xs = [emb[s.long()].float() for s in seqs]
    del emb
    for li, (mixer, ffn, *_) in enumerate(m["layers"]):
        p = {k: v.float() for k, v in get(1 + li).items()}
        pre = f"layers.{li}."
        mix = mamba if mixer == "mamba" else decoder.attention
        for i, x in enumerate(xs):
            x = x + mix(m, p, pre, decoder.rmsnorm(x, p[pre + "norm1"], eps),
                        lin)
            if ffn != "none":
                x = x + decoder.ffn(m if ffn == "moe" else _dense(m), p, pre,
                                    decoder.rmsnorm(x, p[pre + "norm2"],
                                                    eps), lin)
            xs[i] = x
    fn = get(1 + L)["final_norm"]
    return [decoder.rmsnorm(x[k.long()], fn, eps) for x, k in zip(xs, keep)]


logits = decoder.logits
