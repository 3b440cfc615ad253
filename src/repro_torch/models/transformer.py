"""The fused serve forward of the dense decoder family, in PyTorch.

Counterpart of the serve path of the JAX package's
``models/transformer.py``: ``init_params``, ``init_paged_cache``,
``_paged_write``, ``_paged_view``, ``_attn_paged``, ``_apply_ffn``,
``_embed``, ``_fused_block`` and ``fused_serve_forward`` keep their
names, their parameter layouts (``wq [d, H, hd]``, ``wo [H, hd, d]``,
``embed [V_pad, d]``, ``lm_head [d, V_pad]``) and their einsums.

Two departures, both for memory: the page writes update the cache in
place (JAX returns a new cache), and the paged cache carries one more
page than the pool grants, the sink page ``num_blocks``, which takes the
writes JAX drops as out of bounds. Nothing reads the sink: block tables
only hold granted pages.

Attention reads go through ``kernels.ops``: the hand-written CUDA kernels
for tensors on the card, the plain PyTorch versions on the CPU.
Mixture-of-experts, Mamba, sliding-window and encoder-decoder families
are not ported yet and raise ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple

import torch
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.kernels import ops

from .config import ATTN, DENSE, ModelConfig
from .layers import apply_rope, rmsnorm, swiglu


def check_supported(cfg: ModelConfig) -> None:
    """Raise unless ``cfg`` is a dense decoder the port can serve."""
    if cfg.is_encdec or cfg.frontend is not None or any(
            l.mixer != ATTN or l.ffn != DENSE for l in cfg.layers):
        raise NotImplementedError(
            f"{cfg.name}: the port serves dense decoder-only families "
            f"(full attention + dense FFN) so far; MoE, Mamba2, sliding "
            f"window and encoder-decoder wait in ROADMAP.md queue 1")


# ================================================================ params

def _param(*shape, device, dtype) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, device=device, dtype=dtype),
                        requires_grad=False)


class Attention(nn.Module):
    def __init__(self, cfg: ModelConfig, device, dtype):
        super().__init__()
        d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, \
            cfg.head_dim
        kw = dict(device=device, dtype=dtype)
        self.wq = _param(d, h, hd, **kw)
        self.wk = _param(d, kv, hd, **kw)
        self.wv = _param(d, kv, hd, **kw)
        self.wo = _param(h, hd, d, **kw)


class DenseFFN(nn.Module):
    def __init__(self, cfg: ModelConfig, device, dtype):
        super().__init__()
        d, f = cfg.d_model, cfg.d_ff
        kw = dict(device=device, dtype=dtype)
        self.w_gate = _param(d, f, **kw)
        self.w_up = _param(d, f, **kw)
        self.w_down = _param(f, d, **kw)


class Layer(nn.Module):
    def __init__(self, cfg: ModelConfig, device, dtype):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.norm1 = _param(cfg.d_model, **kw)
        self.attn = Attention(cfg, **kw)
        self.norm2 = _param(cfg.d_model, **kw)
        self.ffn = DenseFFN(cfg, **kw)


class Transformer(nn.Module):
    """The parameters, named as the JAX parameter tree is nested:
    ``embed``, ``final_norm``, ``lm_head``, ``layers.3.attn.wq``,
    ``layers.3.ffn.w_gate``, ``layers.3.norm1`` ... The forward pass is
    ``fused_serve_forward``, a plain function over this container."""

    def __init__(self, cfg: ModelConfig, device, dtype):
        super().__init__()
        check_supported(cfg)
        kw = dict(device=device, dtype=dtype)
        self.embed = _param(cfg.vocab_padded, cfg.d_model, **kw)
        self.final_norm = _param(cfg.d_model, **kw)
        self.layers = nn.ModuleList(Layer(cfg, **kw)
                                    for _ in range(cfg.num_layers))
        self.lm_head = None if cfg.tie_embeddings else \
            _param(cfg.d_model, cfg.vocab_padded, **kw)


# std of each weight's normal draw, as the JAX init_params scales it
def _init_std(name: str, cfg: ModelConfig) -> float:
    d, f, h, hd = cfg.d_model, cfg.d_ff, cfg.num_heads, cfg.head_dim
    leaf = name.rsplit(".", 1)[-1]
    return {"embed": 0.02, "lm_head": 0.02, "wq": d ** -0.5,
            "wk": d ** -0.5, "wv": d ** -0.5, "wo": (h * hd) ** -0.5,
            "w_gate": d ** -0.5, "w_up": d ** -0.5,
            "w_down": f ** -0.5}[leaf]


@torch.no_grad()
def init_params(cfg: ModelConfig, generator: torch.Generator,
                device="cuda", dtype=torch.float32) -> Transformer:
    """Random weights with the JAX ``init_params`` shapes and scales
    (norm weights zero, i.e. unit scale). The numbers come from
    ``generator``, which lives on ``device``; they are not JAX's."""
    dev = resolve_device(device)
    model = Transformer(cfg, dev, dtype)
    for name, p in model.named_parameters():
        if "norm" in name.rsplit(".", 1)[-1]:
            p.zero_()
        else:
            p.copy_(torch.randn(p.shape, generator=generator, device=dev)
                    * _init_std(name, cfg))
    return model


# ================================================================ caches

class PagedAttnCache(NamedTuple):
    """One attention layer's pages: ``[num_blocks + 1, bs, KV, hd]``.
    Page ``num_blocks`` is the sink of invalid writes (see module
    docstring). A table's logical block ``j`` holds positions
    ``j*bs .. (j+1)*bs - 1``; stale page contents are masked by the read
    path, as in the JAX ``PagedAttnCache``."""
    k: torch.Tensor
    v: torch.Tensor


def init_paged_cache(cfg: ModelConfig, num_blocks: int, block_size: int,
                     dtype=torch.float32, device="cuda") -> Dict:
    """Zeroed pages for every layer on ``device``, the sink page
    included. Raises without a card unless ``device="cpu"``."""
    check_supported(cfg)
    dev = resolve_device(device)
    shape = (num_blocks + 1, block_size, cfg.num_kv_heads, cfg.head_dim)
    return {"layers": [
        PagedAttnCache(torch.zeros(shape, dtype=dtype, device=dev),
                       torch.zeros(shape, dtype=dtype, device=dev))
        for _ in cfg.layers]}


def _paged_write(c: PagedAttnCache, k_new, v_new, start_pos, bt,
                 valid) -> None:
    """Write S new tokens into their table-resolved pages, in place.
    ``bt``: [B, maxb] int32 (-1 empty). Invalid writes (pad rows and
    columns, inactive decode slots, unallocated table entries) go to the
    sink page: JAX routes them to block ``num_blocks`` and its scatter
    drops them, where torch's ``index_put_`` would raise on the CPU or
    write out of bounds on the card."""
    S = k_new.shape[1]
    nb, bs = c.k.shape[0] - 1, c.k.shape[1]
    maxb = bt.shape[1]
    gpos = start_pos[:, None] + torch.arange(S, device=k_new.device)[None]
    bi = torch.div(gpos, bs, rounding_mode="floor")
    off = gpos % bs
    blk = torch.gather(bt, 1, bi.clamp(max=maxb - 1).long())
    ok = (bi < maxb) & (blk >= 0)
    if valid is not None:
        ok = ok & valid
    idx = (torch.where(ok, blk, nb).long(), off.long())
    c.k.index_put_(idx, k_new.to(c.k.dtype))
    c.v.index_put_(idx, v_new.to(c.v.dtype))


def _paged_view(c: PagedAttnCache, bt):
    """Gather each row's pages into a contiguous [B, maxb*bs, KV, hd]
    view in logical-position order. Unallocated entries read page 0; the
    attention mask hides them."""
    idx = bt.clamp_min(0).long()
    k, v = c.k[idx], c.v[idx]                 # [B, maxb, bs, KV, hd]
    B, maxb, bs = k.shape[:3]
    return (k.reshape(B, maxb * bs, *k.shape[3:]),
            v.reshape(B, maxb * bs, *v.shape[3:]))


# ================================================================ layers

def _attn_paged(p: Attention, cfg: ModelConfig, x, cache: PagedAttnCache,
                bt, start_pos, lens, valid, decode: bool):
    """Cached attention over the paged pool: write through the block
    table, then read. Decode rows go to ``paged_attention`` with the
    block table (no gather); prefill rows to ``chunked_prefill_attention``
    over the gathered view with per-row offsets, as the JAX kernel branch
    does."""
    B, S, _ = x.shape
    q = torch.einsum("bsd,dhk->bshk", x, p.wq)
    k = torch.einsum("bsd,dhk->bshk", x, p.wk)
    v = torch.einsum("bsd,dhk->bshk", x, p.wv)
    qpos = start_pos[:, None] + torch.arange(S, device=x.device)[None]
    q = apply_rope(q, qpos, cfg.rope_theta)
    k = apply_rope(k, qpos, cfg.rope_theta)
    _paged_write(cache, k, v, start_pos, bt, valid)
    kv_lens = (start_pos + lens).to(torch.int32)
    if decode:
        o = ops.paged_attention(q[:, 0], cache.k, cache.v, bt,
                                kv_lens)[:, None]
    else:
        kview, vview = _paged_view(cache, bt)
        o = ops.chunked_prefill_attention(
            q, kview, vview, q_offsets=start_pos.to(torch.int32),
            kv_lens=kv_lens)
    return torch.einsum("bshk,hkd->bsd", o, p.wo)


def _apply_ffn(p: Layer, cfg: ModelConfig, x):
    h = rmsnorm(x, p.norm2, cfg.norm_eps)
    f = p.ffn
    return x + swiglu(h, f.w_gate, f.w_up, f.w_down)


def _embed(params: Transformer, tokens):
    return params.embed[tokens.long()]


def _fused_block(p: Layer, cfg: ModelConfig, x_pre, x_dec,
                 cache: PagedAttnCache, pre_start, pre_len, pre_valid,
                 dec_start, dec_active, pre_bt, dec_bt):
    """One layer of the fused serve iteration: the prefill sub-batch
    ([P, L] chunk rows) and the decode sub-batch ([N, 1]) advance
    together; a request is in one of them only, so their page writes
    touch disjoint pages. An absent sub-batch (size 0) is skipped, as
    JAX traces no machinery for it."""
    if x_pre.shape[0]:
        h = rmsnorm(x_pre, p.norm1, cfg.norm_eps)
        x_pre = x_pre + _attn_paged(p.attn, cfg, h, cache, pre_bt,
                                    pre_start, pre_len, pre_valid, False)
        x_pre = _apply_ffn(p, cfg, x_pre)
    if x_dec.shape[0]:
        h = rmsnorm(x_dec, p.norm1, cfg.norm_eps)
        x_dec = x_dec + _attn_paged(
            p.attn, cfg, h, cache, dec_bt, dec_start,
            dec_active.to(dec_start.dtype), dec_active[:, None], True)
        x_dec = _apply_ffn(p, cfg, x_dec)
    return x_pre, x_dec


def _sampled_hidden(params: Transformer, cfg: ModelConfig, cache: Dict,
                    pre_tokens, pre_start, pre_len, pre_sample_col,
                    dec_tokens, dec_start, dec_active, pre_bt, dec_bt):
    """Every layer of one fused iteration, then the final norm of the
    rows that are sampled: ``[P + N, d]``, prefill rows (their
    ``pre_sample_col`` column) then decode slots. This is what the LM
    head reads."""
    P, L = pre_tokens.shape
    x_pre = _embed(params, pre_tokens)
    x_dec = _embed(params, dec_tokens[:, None])
    pre_valid = torch.arange(L, device=pre_len.device)[None] \
        < pre_len[:, None]
    for li, layer in enumerate(params.layers):
        x_pre, x_dec = _fused_block(
            layer, cfg, x_pre, x_dec, cache["layers"][li], pre_start,
            pre_len, pre_valid, dec_start, dec_active, pre_bt, dec_bt)
    parts: List[torch.Tensor] = []
    if P:
        # the norm is per row: gathering the sampled column first gives
        # the rows JAX gets by norming every column and then gathering
        parts.append(x_pre[torch.arange(P, device=x_pre.device),
                           pre_sample_col.long()])
    if dec_tokens.shape[0]:
        parts.append(x_dec[:, 0])
    xs = parts[0] if len(parts) == 1 else torch.cat(parts, dim=0)
    return rmsnorm(xs, params.final_norm, cfg.norm_eps)


@torch.inference_mode()
def fused_serve_forward(params: Transformer, cfg: ModelConfig, cache: Dict,
                        pre_tokens, pre_start, pre_len, pre_sample_col,
                        dec_tokens, dec_start, dec_active,
                        pre_bt=None, dec_bt=None) -> torch.Tensor:
    """ONE fused serve iteration executing a whole BatchPlan, with greedy
    sampling on the device. The arguments are those of the JAX
    ``fused_serve_forward`` (paged layout) without the two that only the
    Mamba and dense-layout paths read (``pre_slots``, ``pre_reset``):

      pre_tokens [P, L] int32, pre_start / pre_len / pre_sample_col [P]
      int32 (pre_len 0 = pad row); dec_tokens / dec_start [N] int32,
      dec_active [N] bool; pre_bt [P, maxb] / dec_bt [N, maxb] int32
      block tables (-1 = unallocated).

    The cache's pages are updated in place. Returns the sampled ids, ``[P + N]`` int32 (prefill rows, then
    decode slots)."""
    xs = _sampled_hidden(params, cfg, cache, pre_tokens, pre_start,
                         pre_len, pre_sample_col, dec_tokens, dec_start,
                         dec_active, pre_bt, dec_bt)
    w = params.lm_head if params.lm_head is not None else params.embed.T
    logits = xs @ w
    # torch.argmax, like jnp.argmax, returns the first maximum
    return torch.argmax(logits[:, :cfg.vocab_size], dim=-1).to(torch.int32)
