"""Plain reference of the decoder-only transformers the benchmark serves:
Qwen-7B (dense SwiGLU) and Qwen3-30B-A3B (routed top-k experts).

Plain PyTorch, float32, no kernels, no cache, no batching across
sequences: each sequence runs whole and causal through every layer, one
layer at a time over all sequences, so that a layer's weights are held
once and only while it runs. TF32 has to be off (``run.py`` sets it).
It imports nothing of the program and takes nothing that the program
made: its weights come from ``get(stream)``, the benchmark's own seeded
draw (``nbench/weights.py``) of the leaves that ``layer_leaves`` names.
It is the ``decoder`` family (``nbench/family.py`` gives the contract):
``layer_leaves``, ``final_hidden``, ``logits``, ``step_flops`` and
``kv_layers``.

The block, as published: RMSNorm with gain ``g`` (stored as ``g - 1``),
rotary embedding over the two halves of each head (base ``rope_theta``),
causal softmax attention at scale ``head_dim ** -0.5`` with
``num_kv_heads`` key / value heads shared by groups of query heads, the
output projection, a second RMSNorm, then either SwiGLU ``w_down(silu(x
w_gate) * x w_up)`` or the router's softmax, its top ``top_k`` experts
with their weights renormalised to sum to one (Qwen3's
``norm_topk_prob``), each chosen expert's SwiGLU, weighted and summed;
the final RMSNorm and the output head. Departures from the published
models, which the program shares: no bias on Qwen-7B's QKV projection
and no per-head RMSNorm of Qwen3's queries and keys (each config file
lists them).

``precision="fp8"`` is the control: the operands of every product with
a weight (the projections, the experts, the router and the output head;
activations by row, weights by output column) rounded to float8 e4m3
with a per-row or per-column scale before the product, the rest as
above.
"""
from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Sequence, Tuple

import torch
import torch.nn.functional as F

FP8_MAX = 448.0
ROW_BLOCK = 16384


def layer_leaves(m: dict, li: int) -> List[Tuple[str, tuple, float]]:
    """(name, shape, std) of layer ``li``'s leaves, as the program's
    ``state_dict`` names them; std 0 marks a norm. The scales are fan-in
    scales: ``d ** -0.5`` for the projections out of the model width and
    the router, ``(H * hd) ** -0.5`` for ``wo``, ``f ** -0.5`` for
    ``w_down``."""
    d, H, KV, hd = m["d_model"], m["num_heads"], m["num_kv_heads"], \
        m["head_dim"]
    p = f"layers.{li}."
    out = [(p + "norm1", (d,), 0.0),
           (p + "attn.wq", (d, H, hd), d ** -0.5),
           (p + "attn.wk", (d, KV, hd), d ** -0.5),
           (p + "attn.wv", (d, KV, hd), d ** -0.5),
           (p + "attn.wo", (H, hd, d), (H * hd) ** -0.5),
           (p + "norm2", (d,), 0.0)]
    moe = m.get("moe")
    if moe:
        E, f = moe["num_experts"], moe["d_ff_expert"]
        out += [(p + "moe.router", (d, E), d ** -0.5),
                (p + "moe.w_gate", (E, d, f), d ** -0.5),
                (p + "moe.w_up", (E, d, f), d ** -0.5),
                (p + "moe.w_down", (E, f, d), f ** -0.5)]
    else:
        f = m["d_ff"]
        out += [(p + "ffn.w_gate", (d, f), d ** -0.5),
                (p + "ffn.w_up", (d, f), d ** -0.5),
                (p + "ffn.w_down", (f, d), f ** -0.5)]
    return out


def kv_layers(m: dict) -> int:
    """Every layer holds paged KV."""
    return m["num_layers"]


def step_flops(m: dict, chunks: Iterable[Tuple[int, int]],
               ctxs: Iterable[int], sampled: int) -> float:
    """Model FLOPs of one step: every layer's projections and FFN for
    each real token (a routed FFN counts its ``top_k`` experts and the
    router), the attention's two products over each query's visible
    keys, and the output head for the ``sampled`` rows that emit a
    token. ``chunks``: the prefill chunks ``(start, real)``; ``ctxs``:
    the decode rows' lengths after this step's write."""
    d, H, KV, hd, L = (m["d_model"], m["num_heads"], m["num_kv_heads"],
                       m["head_dim"], m["num_layers"])
    proj = 2.0 * (2 * d * H * hd + 2 * d * KV * hd)
    moe = m.get("moe")
    if moe:
        ffn = 2.0 * d * moe["num_experts"] \
            + moe["top_k"] * 6.0 * d * moe["d_ff_expert"]
    else:
        ffn = 6.0 * d * m["d_ff"]
    chunks, ctxs = list(chunks), list(ctxs)
    tokens = sum(r for _, r in chunks) + len(ctxs)
    pairs = sum(r * s + r * (r + 1) // 2 for s, r in chunks) + sum(ctxs)
    return L * (tokens * (proj + ffn) + 4.0 * H * hd * pairs) \
        + sampled * 2.0 * d * m["vocab_size"]


def _fp8(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 with one scale per slice along
    ``dim``'s complement (the amax over ``dim`` maps to the format's
    largest value), returned in float32."""
    s = t.abs().amax(dim=dim, keepdim=True).clamp_min(1e-12) / FP8_MAX
    return (t / s).to(torch.float8_e4m3fn).to(torch.float32) * s


class Linear:
    """``x @ w`` over the last axis of x and the first of w (w is
    ``[k, ...]``), in float32 or through the fp8 control."""

    def __init__(self, precision: str):
        self.fp8 = precision == "fp8"

    def __call__(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        w2 = w.reshape(w.shape[0], -1).float()
        if self.fp8:
            x = _fp8(x, -1)
            w2 = _fp8(w2, 0)
        return (x @ w2).reshape(*x.shape[:-1], *w.shape[1:])


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    x = x.float()
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) \
        * (1.0 + w.float())


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x: [S, H, D] at positions 0..S-1."""
    S, _, D = x.shape
    inv = 1.0 / theta ** (torch.arange(0, D, 2, dtype=torch.float32,
                                       device=x.device) / D)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] \
        * inv[None]
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def attention(m: dict, p: Dict[str, torch.Tensor], pre: str,
              h: torch.Tensor, lin: Linear) -> torch.Tensor:
    """One sequence's causal self-attention: h [S, d] -> [S, d]."""
    H, KV, hd = m["num_heads"], m["num_kv_heads"], m["head_dim"]
    q = rope(lin(h, p[pre + "attn.wq"]), m["rope_theta"])      # [S, H, hd]
    k = rope(lin(h, p[pre + "attn.wk"]), m["rope_theta"])
    v = lin(h, p[pre + "attn.wv"])
    g = H // KV
    q = q.transpose(0, 1)[None]                                # [1,H,S,hd]
    k = k.transpose(0, 1).repeat_interleave(g, dim=0)[None]
    v = v.transpose(0, 1).repeat_interleave(g, dim=0)[None]
    o = F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                       scale=hd ** -0.5)
    o = o[0].transpose(0, 1)                                   # [S,H,hd]
    wo = p[pre + "attn.wo"]
    return lin(o.reshape(o.shape[0], -1), wo.reshape(-1, wo.shape[-1]))


def swiglu(x, w_gate, w_up, w_down, lin: Linear) -> torch.Tensor:
    return lin(F.silu(lin(x, w_gate)) * lin(x, w_up), w_down)


def ffn(m: dict, p: Dict[str, torch.Tensor], pre: str, h: torch.Tensor,
        lin: Linear) -> torch.Tensor:
    """The FFN of rows h [T, d]: dense SwiGLU, or the routed experts."""
    moe = m.get("moe")
    if not moe:
        return swiglu(h, p[pre + "ffn.w_gate"], p[pre + "ffn.w_up"],
                      p[pre + "ffn.w_down"], lin)
    probs = torch.softmax(lin(h, p[pre + "moe.router"]), dim=-1)
    top_w, top_e = torch.topk(probs, moe["top_k"], dim=-1)
    top_w = top_w / top_w.sum(-1, keepdim=True)
    out = torch.zeros_like(h)
    wg, wu, wd = (p[pre + "moe." + n] for n in ("w_gate", "w_up", "w_down"))
    for e in torch.unique(top_e).tolist():
        rows, slot = torch.nonzero(top_e == e, as_tuple=True)
        y = swiglu(h[rows], wg[e], wu[e], wd[e], lin)
        out.index_add_(0, rows, y * top_w[rows, slot][:, None])
    return out


def final_hidden(m: dict, get: Callable[[int], Dict[str, torch.Tensor]],
                 seqs: Sequence[torch.Tensor], keep: Sequence[torch.Tensor],
                 precision: str = "fp32") -> List[torch.Tensor]:
    """The final-normed hidden states of each sequence (token ids [S_i])
    at its positions ``keep[i]``, as float32 [n_i, d]. ``get(stream)``
    returns the weights of a draw: 0 the embedding, 1 + i layer i, 1 + L
    the final norm."""
    lin = Linear(precision)
    eps, L = m["norm_eps"], m["num_layers"]
    emb = get(0)["embed"]
    xs = [emb[s.long()].float() for s in seqs]
    del emb
    for li in range(L):
        p = {k: v.float() for k, v in get(1 + li).items()}
        pre = f"layers.{li}."
        for i, x in enumerate(xs):
            x = x + attention(m, p, pre, rmsnorm(x, p[pre + "norm1"], eps),
                              lin)
            for r in range(0, x.shape[0], ROW_BLOCK):
                blk = x[r:r + ROW_BLOCK]
                x[r:r + ROW_BLOCK] = blk + ffn(
                    m, p, pre, rmsnorm(blk, p[pre + "norm2"], eps), lin)
            xs[i] = x
        del p
    fn = get(1 + L)["final_norm"]
    return [rmsnorm(x[k.long()], fn, eps) for x, k in zip(xs, keep)]


def logits(m: dict, head: torch.Tensor, hid: torch.Tensor,
           precision: str = "fp32") -> torch.Tensor:
    """[n, vocab_size] float32 logits of final hidden states; ``head`` is
    the ``[d, V_pad]`` output head."""
    return Linear(precision)(hid, head[:, :m["vocab_size"]])

