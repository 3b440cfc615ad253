"""The fused serve forward of the dense decoder and Mamba2 families, in
PyTorch.

Counterpart of the serve path of the JAX package's
``models/transformer.py``: ``init_params``, ``init_paged_cache`` (with
its int8 ``QuantPagedAttnCache`` and ``_quantize``), ``_paged_write``,
``_paged_view``, ``_attn_paged``, ``_gather_cache_rows``,
``_scatter_cache_rows``, ``_apply_ffn``, ``_embed``, ``_fused_block`` and
``fused_serve_forward`` keep their names, their parameter layouts
(``wq [d, H, hd]``, ``wo [H, hd, d]``, ``embed [V_pad, d]``,
``lm_head [d, V_pad]``, the Mamba leaves of ``models/mamba2.py``) and
their einsums.

Departures, all for memory: the page writes and the Mamba state updates
happen in place (JAX returns a new cache); the paged cache carries one
more page than the pool grants, the sink page ``num_blocks``, which takes
the writes JAX drops as out of bounds; and each Mamba layer's state
carries one more row than there are slots, the sink row ``n_slots``,
which takes the scatter of pad prefill rows that JAX drops. Nothing
reads either sink for a live request: block tables only hold granted
pages, and pad rows' outputs are discarded.

Attention reads, the norms and the SSD scan go through ``kernels.ops``:
the hand-written CUDA kernels for tensors on the card, the plain PyTorch
versions on the CPU. Mixture-of-experts FFNs (``models/moe.py``) serve
through ``moe_forward_grouped`` by default, or ``moe_forward_dropless``
on request (``moe_impl``), as in the JAX fused serve path.
Sliding-window layers (``SWA``) hold pages like full-attention layers and
read them through ``chunked_prefill_attention`` with their window, in
prefill and in decode, as the JAX kernel branch does; their block tables
may hold ``-1`` holes where the engine reclaimed pages that slid out of
every window. Encoder-decoder families and modality frontends are not
ported yet and raise ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple

import torch
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.kernels import ops

from .config import ATTN, DENSE, MAMBA, MOE, NONE, SWA, ModelConfig
from .layers import apply_rope, rmsnorm, swiglu
from .mamba2 import (Mamba, MambaState, init_mamba_params, init_mamba_state,
                     mamba_forward, mamba_step)
from .moe import MoE, moe_forward_dropless, moe_forward_grouped

# the serve-path MoE FFNs, by the name ``moe_impl`` gives them
MOE_IMPLS = {"grouped": moe_forward_grouped,
             "dropless": moe_forward_dropless}


def check_supported(cfg: ModelConfig) -> None:
    """Raise unless ``cfg`` is a decoder the port can serve: every layer
    mixes with full attention, sliding-window attention or Mamba2, and
    its FFN is dense, MoE or absent."""
    if cfg.is_encdec or cfg.frontend is not None or any(
            l.mixer not in (ATTN, SWA, MAMBA)
            or l.ffn not in (DENSE, MOE, NONE) for l in cfg.layers):
        raise NotImplementedError(
            f"{cfg.name}: the port serves decoder-only families of full "
            f"attention, sliding-window attention or Mamba2 layers with a "
            f"dense or MoE FFN or none so far; encoder-decoder and "
            f"modality frontends wait in ROADMAP.md queue 1")


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
    """One block, holding what the JAX ``_init_layer`` holds: ``norm1``
    and ``mamba`` or ``attn``; ``norm2`` and ``ffn`` (dense) or ``moe``
    only where the layer has an FFN."""

    def __init__(self, cfg: ModelConfig, spec, device, dtype):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.norm1 = _param(cfg.d_model, **kw)
        if spec.mixer == MAMBA:
            self.mamba = Mamba(cfg, **kw)
        else:
            self.attn = Attention(cfg, **kw)
        if spec.ffn == MOE:
            self.norm2 = _param(cfg.d_model, **kw)
            self.moe = MoE(cfg, **kw)
        elif spec.ffn != NONE:
            self.norm2 = _param(cfg.d_model, **kw)
            self.ffn = DenseFFN(cfg, **kw)


class Transformer(nn.Module):
    """The parameters, named as the JAX parameter tree is nested:
    ``embed``, ``final_norm``, ``lm_head``, ``layers.3.attn.wq``,
    ``layers.3.ffn.w_gate``, ``layers.3.moe.router``,
    ``layers.3.mamba.A_log``, ``layers.3.norm1`` ... The forward pass
    is ``fused_serve_forward``, a plain function over this container."""

    def __init__(self, cfg: ModelConfig, device, dtype):
        super().__init__()
        check_supported(cfg)
        kw = dict(device=device, dtype=dtype)
        self.embed = _param(cfg.vocab_padded, cfg.d_model, **kw)
        self.final_norm = _param(cfg.d_model, **kw)
        self.layers = nn.ModuleList(Layer(cfg, spec, **kw)
                                    for spec in cfg.layers)
        self.lm_head = None if cfg.tie_embeddings else \
            _param(cfg.d_model, cfg.vocab_padded, **kw)


# std of each attention, FFN and MoE weight's normal draw, as the JAX
# init_params and init_moe_params scale it (the Mamba leaves:
# ``init_mamba_params``)
def _init_std(name: str, cfg: ModelConfig) -> float:
    leaf = name.rsplit(".", 1)[-1]
    if leaf in ("embed", "lm_head"):
        return 0.02
    d, h, hd = cfg.d_model, cfg.num_heads, cfg.head_dim
    f = cfg.moe.d_ff_expert if ".moe." in name else cfg.d_ff
    fan_in = {"wq": d, "wk": d, "wv": d, "wo": h * hd, "router": d,
              "w_gate": d, "w_up": d, "w_down": f}[leaf]
    return fan_in ** -0.5


@torch.no_grad()
def init_params(cfg: ModelConfig, generator: torch.Generator,
                device="cuda", dtype=torch.float32) -> Transformer:
    """Random weights with the JAX ``init_params`` shapes and scales
    (norm weights zero, i.e. unit scale; the Mamba leaves as
    ``init_mamba_params`` sets them). The numbers come from
    ``generator``, which lives on ``device``; they are not JAX's."""
    dev = resolve_device(device)
    model = Transformer(cfg, dev, dtype)
    for name, p in model.named_parameters():
        if ".mamba." in name:
            continue
        if "norm" in name.rsplit(".", 1)[-1]:
            p.zero_()
        else:
            p.copy_(torch.randn(p.shape, generator=generator, device=dev)
                    * _init_std(name, cfg))
    for layer in model.layers:
        if hasattr(layer, "mamba"):
            init_mamba_params(layer.mamba, cfg, generator)
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


class QuantPagedAttnCache(NamedTuple):
    """int8 KV on the paged layout, as the JAX ``QuantPagedAttnCache``:
    ``k``/``v`` int8 ``[num_blocks + 1, bs, KV, hd]`` and their bf16
    scale pages ``k_scale``/``v_scale`` ``[num_blocks + 1, bs, KV]``,
    one symmetric scale per (token, kv-head), indexed by the same block
    tables. A block is its pages and its scales, so every pool operation
    (grant, free, swap, prefix share) moves quantized blocks through the
    tuple's fields without knowing about quantization. Page
    ``num_blocks`` is the sink, as in ``PagedAttnCache``."""
    k: torch.Tensor
    v: torch.Tensor
    k_scale: torch.Tensor
    v_scale: torch.Tensor


def init_paged_cache(cfg: ModelConfig, n_slots: int, num_blocks: int,
                     block_size: int, dtype=torch.float32, device="cuda",
                     kv_quant: bool = False) -> Dict:
    """The zeroed serving cache on ``device``, with the arguments of the
    JAX ``init_paged_cache``: attention layers share the page pool
    (``num_blocks`` pages and the sink page), Mamba layers keep their
    O(1) recurrent state per slot (``n_slots`` rows and the sink row).
    ``kv_quant`` stores int8 pages with bf16 scale pages beside them.
    Raises without a card unless ``device="cpu"``."""
    check_supported(cfg)
    dev = resolve_device(device)
    shape = (num_blocks + 1, block_size, cfg.num_kv_heads, cfg.head_dim)

    def zeros(shape, dt):
        return torch.zeros(shape, dtype=dt, device=dev)

    def attn_cache():
        if kv_quant:
            return QuantPagedAttnCache(
                zeros(shape, torch.int8), zeros(shape, torch.int8),
                zeros(shape[:3], torch.bfloat16),
                zeros(shape[:3], torch.bfloat16))
        return PagedAttnCache(zeros(shape, dtype), zeros(shape, dtype))
    return {"layers": [
        init_mamba_state(n_slots + 1, cfg, dtype, dev)
        if spec.mixer == MAMBA else attn_cache() for spec in cfg.layers]}


def _quantize(x):
    """Symmetric per-(token, head) int8 quantization, the JAX
    ``_quantize`` op for op: the scale is ``max|x| / 127`` in fp32,
    floored at 1e-8; values are ``x / scale`` rounded half to even and
    clipped to +-127; the scale is stored in bf16. x: [..., hd].
    Returns (int8 [..., hd], bf16 [...])."""
    xf = x.float()
    scale = torch.amax(xf.abs(), dim=-1) / 127.0
    scale = scale.clamp_min(1e-8)
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale.to(torch.bfloat16)


def _paged_write(c: PagedAttnCache, k_new, v_new, start_pos, bt,
                 valid) -> None:
    """Write S new tokens into their table-resolved pages, in place.
    ``bt``: [B, maxb] int32 (-1 empty). Invalid writes (pad rows and
    columns, inactive decode slots, unallocated table entries) go to the
    sink page: JAX routes them to block ``num_blocks`` and its scatter
    drops them, where torch's ``index_put_`` would raise on the CPU or
    write out of bounds on the card. Quant pages quantize on write with
    ``_quantize``; the scales go through the same ``(block, offset)``
    index as their pages."""
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
    if isinstance(c, QuantPagedAttnCache):
        k8, ks = _quantize(k_new)
        v8, vs = _quantize(v_new)
        c.k.index_put_(idx, k8)
        c.v.index_put_(idx, v8)
        c.k_scale.index_put_(idx, ks)
        c.v_scale.index_put_(idx, vs)
        return
    c.k.index_put_(idx, k_new.to(c.k.dtype))
    c.v.index_put_(idx, v_new.to(c.v.dtype))


def _gather_cache_rows(c: MambaState, idx) -> MambaState:
    """The state rows of the prefill sub-batch (a copy). Pad rows carry
    the sink row's index ``n_slots``."""
    return MambaState(conv=c.conv[idx.long()], ssm=c.ssm[idx.long()])


def _scatter_cache_rows(c: MambaState, sub: MambaState, idx) -> None:
    """Write the prefill sub-batch's rows back, in place. Pad rows land
    on the sink row, which JAX's scatter drops as out of bounds."""
    c.conv[idx.long()] = sub.conv.to(c.conv.dtype)
    c.ssm[idx.long()] = sub.ssm


def _paged_view(c, bt):
    """Gather each row's pages into a contiguous [B, maxb*bs, KV, hd]
    view in logical-position order. Unallocated entries read page 0; the
    attention mask hides them. Quant pages dequantize here as the JAX
    ``_paged_view`` does, in bf16: int8 to bf16 times the bf16 scale,
    rounded to bf16."""
    idx = bt.clamp_min(0).long()
    k, v = c.k[idx], c.v[idx]                 # [B, maxb, bs, KV, hd]
    B, maxb, bs = k.shape[:3]
    if isinstance(c, QuantPagedAttnCache):
        k = k.to(torch.bfloat16) * c.k_scale[idx][..., None]
        v = v.to(torch.bfloat16) * c.v_scale[idx][..., None]
    return (k.reshape(B, maxb * bs, *k.shape[3:]),
            v.reshape(B, maxb * bs, *v.shape[3:]))


# ================================================================ layers

def _attn_paged(p: Attention, cfg: ModelConfig, spec, x,
                cache: PagedAttnCache, bt, start_pos, lens, valid,
                decode: bool):
    """Cached attention over the paged pool: write through the block
    table, then read, as the JAX kernel branch does. Decode rows of a
    full-attention layer go to ``paged_attention`` with the block table
    (no gather); prefill rows, and the decode rows of a sliding-window
    layer (``spec.mixer == SWA``), to ``chunked_prefill_attention`` over
    the gathered view with per-row offsets and the layer's window. Int8
    pages hand their scale pages to the decode kernel's fused-dequant
    variant (exact fp32 dequantization); the other reads take the view
    that ``_paged_view`` dequantized in bf16, cast to q's dtype
    (lossless), as JAX's prefill kernel reads it in fp32."""
    B, S, _ = x.shape
    q = torch.einsum("bsd,dhk->bshk", x, p.wq)
    k = torch.einsum("bsd,dhk->bshk", x, p.wk)
    v = torch.einsum("bsd,dhk->bshk", x, p.wv)
    qpos = start_pos[:, None] + torch.arange(S, device=x.device)[None]
    q = apply_rope(q, qpos, cfg.rope_theta)
    k = apply_rope(k, qpos, cfg.rope_theta)
    _paged_write(cache, k, v, start_pos, bt, valid)
    kv_lens = (start_pos + lens).to(torch.int32)
    quant = isinstance(cache, QuantPagedAttnCache)
    window = spec.window if spec.mixer == SWA else None
    if decode and window is None:
        o = ops.paged_attention(
            q[:, 0], cache.k, cache.v, bt, kv_lens,
            k_scales=cache.k_scale if quant else None,
            v_scales=cache.v_scale if quant else None)[:, None]
    else:
        kview, vview = _paged_view(cache, bt)
        o = ops.chunked_prefill_attention(
            q, kview.to(q.dtype), vview.to(q.dtype), window=window,
            q_offsets=start_pos.to(torch.int32), kv_lens=kv_lens)
    return torch.einsum("bshk,hkd->bsd", o, p.wo)


def _apply_ffn(p: Layer, cfg: ModelConfig, spec, x,
               moe_impl: str = "grouped"):
    """The layer's FFN with its residual. A MoE layer serves through
    ``MOE_IMPLS[moe_impl]``, as the JAX fused serve path routes it."""
    if spec.ffn == NONE:
        return x
    h = rmsnorm(x, p.norm2, cfg.norm_eps)
    if spec.ffn == MOE:
        return x + MOE_IMPLS[moe_impl](p.moe, h, cfg)
    f = p.ffn
    return x + swiglu(h, f.w_gate, f.w_up, f.w_down)


def _embed(params: Transformer, tokens):
    return params.embed[tokens.long()]


def _mamba_block(p: Layer, cfg: ModelConfig, x_pre, x_dec,
                 state: MambaState, pre_slots, pre_len, pre_reset,
                 dec_active):
    """The Mamba mixer of one fused iteration, updating ``state`` in
    place. Prefill rows gather their slots' state (zeroed where
    ``pre_reset`` marks a request's first chunk: slot reuse must not leak
    the previous recurrence), run ``mamba_forward`` with ``seq_lens =
    pre_len`` and scatter the result back; the decode batch runs
    ``mamba_step`` over every slot and keeps the new state only where
    ``dec_active`` holds, so inactive slots compute but do not move."""
    if x_pre.shape[0]:
        h = rmsnorm(x_pre, p.norm1, cfg.norm_eps)
        sub = _gather_cache_rows(state, pre_slots)
        sub = MambaState(
            conv=torch.where(pre_reset[:, None, None], 0.0, sub.conv),
            ssm=torch.where(pre_reset[:, None, None, None], 0.0, sub.ssm))
        y, sub = mamba_forward(p.mamba, h, cfg, sub, seq_lens=pre_len)
        _scatter_cache_rows(state, sub, pre_slots)
        x_pre = x_pre + y
    if x_dec.shape[0]:
        n = x_dec.shape[0]
        h = rmsnorm(x_dec, p.norm1, cfg.norm_eps)
        cur = MambaState(state.conv[:n], state.ssm[:n])
        y, new = mamba_step(p.mamba, h, cfg, cur)
        cur.conv.copy_(torch.where(dec_active[:, None, None],
                                   new.conv.to(cur.conv.dtype), cur.conv))
        cur.ssm.copy_(torch.where(dec_active[:, None, None, None], new.ssm,
                                  cur.ssm))
        x_dec = x_dec + y
    return x_pre, x_dec


def _fused_block(p: Layer, cfg: ModelConfig, spec, x_pre, x_dec,
                 layer_cache, pre_slots, pre_start, pre_len, pre_reset,
                 pre_valid, dec_start, dec_active, pre_bt, dec_bt,
                 moe_impl: str = "grouped"):
    """One layer of the fused serve iteration: the prefill sub-batch
    ([P, L] chunk rows) and the decode sub-batch ([N, 1]) advance
    together; a request is in one of them only, so their page writes
    and state updates touch disjoint pages and slots. An absent
    sub-batch (size 0) is skipped, as JAX traces no machinery for it.
    The layer's cache (pages or Mamba state) is updated in place."""
    if spec.mixer == MAMBA:
        x_pre, x_dec = _mamba_block(p, cfg, x_pre, x_dec, layer_cache,
                                    pre_slots, pre_len, pre_reset,
                                    dec_active)
    else:
        if x_pre.shape[0]:
            h = rmsnorm(x_pre, p.norm1, cfg.norm_eps)
            x_pre = x_pre + _attn_paged(p.attn, cfg, spec, h, layer_cache,
                                        pre_bt, pre_start, pre_len,
                                        pre_valid, False)
        if x_dec.shape[0]:
            h = rmsnorm(x_dec, p.norm1, cfg.norm_eps)
            x_dec = x_dec + _attn_paged(
                p.attn, cfg, spec, h, layer_cache, dec_bt, dec_start,
                dec_active.to(dec_start.dtype), dec_active[:, None], True)
    if x_pre.shape[0]:
        x_pre = _apply_ffn(p, cfg, spec, x_pre, moe_impl)
    if x_dec.shape[0]:
        x_dec = _apply_ffn(p, cfg, spec, x_dec, moe_impl)
    return x_pre, x_dec


def _sampled_hidden(params: Transformer, cfg: ModelConfig, cache: Dict,
                    pre_tokens, pre_slots, pre_start, pre_len, pre_reset,
                    pre_sample_col, dec_tokens, dec_start, dec_active,
                    pre_bt, dec_bt, moe_impl: str = "grouped"):
    """Every layer of one fused iteration, then the final norm of the
    rows that are sampled: ``[P + N, d]``, prefill rows (their
    ``pre_sample_col`` column) then decode slots. This is what the LM
    head reads."""
    P, L = pre_tokens.shape
    x_pre = _embed(params, pre_tokens)
    x_dec = _embed(params, dec_tokens[:, None])
    pre_valid = torch.arange(L, device=pre_len.device)[None] \
        < pre_len[:, None]
    for li, spec in enumerate(cfg.layers):
        x_pre, x_dec = _fused_block(
            params.layers[li], cfg, spec, x_pre, x_dec, cache["layers"][li],
            pre_slots, pre_start, pre_len, pre_reset, pre_valid, dec_start,
            dec_active, pre_bt, dec_bt, moe_impl)
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
                        pre_tokens, pre_slots, pre_start, pre_len,
                        pre_reset, pre_sample_col, dec_tokens, dec_start,
                        dec_active, pre_bt=None, dec_bt=None,
                        moe_impl: str = "grouped") -> torch.Tensor:
    """ONE fused serve iteration executing a whole BatchPlan, with greedy
    sampling on the device. The arguments are those of the JAX
    ``fused_serve_forward`` (paged layout):

      pre_tokens [P, L] int32; pre_slots [P] int32 (each row's slot,
      ``n_slots`` for pad rows); pre_start / pre_len [P] int32 (pre_len 0
      = pad row); pre_reset [P] bool (a request's first chunk: zero its
      Mamba state); pre_sample_col [P] int32; dec_tokens / dec_start [N]
      int32, dec_active [N] bool; pre_bt [P, maxb] / dec_bt [N, maxb]
      int32 block tables (-1 = unallocated); moe_impl ``"grouped"`` or
      ``"dropless"``, the MoE layers' FFN.

    The cache's pages and Mamba state rows are updated in place. Returns
    the sampled ids, ``[P + N]`` int32 (prefill rows, then decode
    slots)."""
    xs = _sampled_hidden(params, cfg, cache, pre_tokens, pre_slots,
                         pre_start, pre_len, pre_reset, pre_sample_col,
                         dec_tokens, dec_start, dec_active, pre_bt, dec_bt,
                         moe_impl)
    w = params.lm_head if params.lm_head is not None else params.embed.T
    logits = xs @ w
    # torch.argmax, like jnp.argmax, returns the first maximum
    return torch.argmax(logits[:, :cfg.vocab_size], dim=-1).to(torch.int32)
