"""The transformer of every served family, in PyTorch: the offline
forward, the slot cache and the fused serve forward in both KV layouts.

Counterpart of the JAX package's ``models/transformer.py``. These keep
their names, their parameter layouts (``wq [d, H, hd]``, ``wo [H, hd,
d]``, ``embed [V_pad, d]``, ``lm_head [d, V_pad]``, ``norm_cross`` and
``cross`` in the decoder layers of an encoder-decoder model,
``encoder.layers.*`` and ``encoder.final_norm``, the Mamba leaves of
``models/mamba2.py``) and their einsums:

- the parameters: ``init_params``;
- the training forward: ``forward_train``, the ``train`` branches of
  ``_decoder_block`` and ``_apply_ffn``, and ``_cross_caches_train``
  (the functional counterpart of ``_build_cross_caches``);
- the dense slot cache and the offline path: ``AttnCache``,
  ``QuantAttnCache``, ``_dequant``, ``_ring_size``, ``init_cache``,
  ``_write_cache``, ``_attn_cached``, ``_pos_masked_attention`` (and its
  blocked form), ``_attn_train``, ``_cross_attn``, ``_encoder_forward``,
  ``_build_cross_caches``, ``_decoder_block``, ``prefill`` and
  ``decode_step``, which the reference engine runs;
- the fused serve path: ``init_paged_cache`` (with its int8
  ``QuantPagedAttnCache`` and ``_quantize``), ``_paged_write``,
  ``_paged_view``, ``_attn_paged`` (paged layout), ``_attn_pallas``
  (dense layout), ``_gather_cache_rows``, ``_scatter_cache_rows``,
  ``_apply_ffn``, ``_embed``, ``_fused_block`` and
  ``fused_serve_forward``.

Departures, all for memory: cache writes and Mamba state updates happen
in place (JAX returns a new cache); and every cache carries a sink that
takes the writes JAX drops as out of bounds. The paged cache carries one
more page than the pool grants (page ``num_blocks``); the dense cache,
its Mamba states and its cross caches one more row than the batch (row
``batch``), not a column, so that ``cache.k[:n_slots]`` stays contiguous
and the decode kernel's 256-token pages are a view of it. Nothing reads
a sink for a live request: block tables only hold granted pages, pad
rows' outputs are discarded, and the offline path reads rows
``[:batch]``.

The fused path's attention reads, every norm and the SSD scan go through
``kernels.ops``: the hand-written CUDA kernels for tensors on the card,
the plain PyTorch versions on the CPU. The offline path's attention is
the JAX package's jnp attention (``models/layers.py``), as torch ops on
every device. Mixture-of-experts FFNs (``models/moe.py``) serve through
``moe_forward_grouped`` in the fused engine by default and through
``moe_forward_dropless`` in the offline path, as in JAX's serve paths
(the offline path is JAX's with ``serve=True``), and train through the
capacity dispatch ``moe_forward``. Sliding-window layers
(``SWA``) read their window, through ``chunked_prefill_attention`` in the
fused path; in the paged layout their block tables may hold ``-1`` holes
where the engine reclaimed pages that slid out of every window.
Encoder-decoder models run the offline path only, as in JAX; a vision
frontend is the stub that zeroes each prefill chunk's leading
``num_tokens`` embeddings.
"""
from __future__ import annotations

import functools
from types import SimpleNamespace
from typing import Callable, Dict, List, Mapping, NamedTuple, Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.distributed.torch_api import (Partial, Replicate, Shard,
                                               einsum, is_dtensor, local_map,
                                               local_offset)
from repro_torch.kernels import ops

from .config import ATTN, DENSE, MAMBA, MOE, NONE, SWA, LayerSpec, ModelConfig
from .layers import (_gqa_out, _gqa_scores, _softmax_masked, apply_rope,
                     blocked_attention, rmsnorm, swa_blocked_attention,
                     swiglu)
from .mamba2 import (Mamba, MambaState, init_mamba_params, init_mamba_state,
                     mamba_forward, mamba_step)
from .moe import MoE, moe_forward, moe_forward_dropless, moe_forward_grouped

# the serve-path MoE FFNs, by the name ``moe_impl`` gives them
MOE_IMPLS = {"grouped": moe_forward_grouped,
             "dropless": moe_forward_dropless}


DEFAULT_RING_CHUNK = 4096   # max prefill chunk a ring cache must absorb


def _identity_shard(t, kind):
    """The serve forward's ``shard(t, kind)`` seam on one device: every
    kind passes through. A tensor-parallel rank passes the gather hooks
    of ``distributed.tp_serve.TPServePlan.shard_fn`` instead."""
    return t


def check_supported(cfg: ModelConfig) -> None:
    """Raise unless every layer of ``cfg`` mixes with full attention,
    sliding-window attention or Mamba2, and its FFN is dense, MoE or
    absent: the layer kinds of the JAX package."""
    if any(l.mixer not in (ATTN, SWA, MAMBA)
           or l.ffn not in (DENSE, MOE, NONE) for l in cfg.layers):
        raise NotImplementedError(
            f"{cfg.name}: a layer kind outside full attention, "
            f"sliding-window attention or Mamba2 with a dense or MoE FFN "
            f"or none")


def _check_decoder_only(cfg: ModelConfig) -> None:
    """The fused serve path covers decoder-only families, as in JAX."""
    if cfg.is_encdec:
        raise NotImplementedError(
            f"{cfg.name}: fused serving covers decoder-only families; use "
            f"ReferenceTorchEngine for encoder-decoder models")


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
    only where the layer has an FFN; with ``cross`` (the decoder layers
    of an encoder-decoder model) ``norm_cross`` and the cross-attention
    ``cross``."""

    def __init__(self, cfg: ModelConfig, spec, device, dtype,
                 cross: bool = False):
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
        if cross:
            self.norm_cross = _param(cfg.d_model, **kw)
            self.cross = Attention(cfg, **kw)


class Encoder(nn.Module):
    """The bidirectional encoder of an encoder-decoder model:
    ``layers`` (attention and a dense FFN each) and ``final_norm``."""

    def __init__(self, cfg: ModelConfig, device, dtype):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.layers = nn.ModuleList(
            Layer(cfg, LayerSpec(ATTN, DENSE), **kw)
            for _ in range(cfg.encoder.num_layers))
        self.final_norm = _param(cfg.d_model, **kw)


class Transformer(nn.Module):
    """The parameters, named as the JAX parameter tree is nested:
    ``embed``, ``final_norm``, ``lm_head``, ``layers.3.attn.wq``,
    ``layers.3.ffn.w_gate``, ``layers.3.moe.router``,
    ``layers.3.mamba.A_log``, ``layers.3.norm1``, ``layers.3.cross.wq``,
    ``encoder.layers.0.attn.wq``, ``encoder.final_norm`` ... The forward
    passes (``prefill``, ``decode_step``, ``fused_serve_forward``) are
    plain functions over this container."""

    def __init__(self, cfg: ModelConfig, device, dtype):
        super().__init__()
        check_supported(cfg)
        kw = dict(device=device, dtype=dtype)
        self.embed = _param(cfg.vocab_padded, cfg.d_model, **kw)
        self.final_norm = _param(cfg.d_model, **kw)
        self.layers = nn.ModuleList(Layer(cfg, spec, cross=cfg.is_encdec,
                                          **kw) for spec in cfg.layers)
        self.lm_head = None if cfg.tie_embeddings else \
            _param(cfg.d_model, cfg.vocab_padded, **kw)
        self.encoder = Encoder(cfg, **kw) if cfg.encoder is not None \
            else None


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
                device="cuda", dtype=torch.float32,
                shard: Optional[Callable] = None) -> Transformer:
    """Random weights with the JAX ``init_params`` shapes and scales
    (norm weights zero, i.e. unit scale; the Mamba leaves as
    ``init_mamba_params`` sets them). The numbers come from
    ``generator``, which lives on ``device``; they are not JAX's.

    Each weight is drawn whole, in ``named_parameters`` order, and
    placed before the next is drawn. ``shard`` (``(name, tensor) ->
    tensor``, a tensor-parallel rank's slicing rule) keeps only its
    slice: the slices are those of the unsharded draw, and no more than
    one whole weight is ever held."""
    dev = resolve_device(device)
    cut = shard or _whole
    model = Transformer(cfg, "meta", dtype)
    for name, p in list(model.named_parameters()):
        if ".mamba." in name:
            continue
        if "norm" in name.rsplit(".", 1)[-1]:
            w = torch.zeros(p.shape, device=dev, dtype=dtype)
        else:
            w = (torch.randn(p.shape, generator=generator, device=dev)
                 * _init_std(name, cfg)).to(dtype)
        _assign(model, name, cut(name, w))
    for layer in model.layers:
        if hasattr(layer, "mamba"):
            layer.mamba = Mamba(cfg, device=dev, dtype=dtype)
            init_mamba_params(layer.mamba, cfg, generator)
    return model


def _whole(name: str, t: torch.Tensor) -> torch.Tensor:
    """The slicing rule of a single-device model: every weight whole."""
    return t


def _assign(model: nn.Module, name: str, t: torch.Tensor) -> None:
    """Make ``t`` the parameter ``name`` of ``model`` (any shape)."""
    mod, _, leaf = name.rpartition(".")
    setattr(model.get_submodule(mod) if mod else model, leaf,
            nn.Parameter(t, requires_grad=False))


@torch.no_grad()
def load_params(cfg: ModelConfig, params: Mapping[str, torch.Tensor],
                device="cuda", dtype=torch.float32,
                shard: Optional[Callable] = None,
                sliced: bool = False) -> Transformer:
    """The model holding ``params`` (a full ``state_dict``, for example
    JAX's weights through ``bridge.params_from_numpy``) on ``device`` in
    ``dtype``, each weight a copy. Every name must be there, and no
    other, and each entry must have its parameter's shape. ``shard`` as
    in ``init_params``: each weight is cut before it is moved. With
    ``sliced`` the entries are a rank's slices already (``shard``'s
    output, ``bridge.rank_params_to_numpy``): each is checked against
    its slice's shape and not cut again."""
    dev = resolve_device(device)
    cut = shard or _whole
    model = Transformer(cfg, "meta", dtype)
    names = [n for n, _ in model.named_parameters()]
    if set(names) != set(params):
        raise KeyError(f"state_dict names differ from the model's: missing "
                       f"{sorted(set(names) - set(params))}, unexpected "
                       f"{sorted(set(params) - set(names))}")
    for name, p in list(model.named_parameters()):
        t = params[name]
        want = cut(name, p).shape if sliced else p.shape
        if t.shape != want:
            raise ValueError(f"state_dict entry {name} has shape "
                             f"{tuple(t.shape)}, the model's "
                             f"{'slice ' if sliced else ''}{tuple(want)}")
        if not sliced:
            t = cut(name, t)
        _assign(model, name, torch.empty(t.shape, device=dev,
                                         dtype=dtype).copy_(t))
    return model


# ================================================================ caches

class AttnCache(NamedTuple):
    """Slot-position KV cache of ``batch`` rows and the sink row:
    ``k``/``v`` ``[batch + 1, R, KV, hd]``, ``pos`` ``[batch + 1, R]``
    int32, the global position of the token in each position slot (-1 =
    empty). Contiguous caches write slot = position, ring caches
    (sliding-window layers) slot = position % R, as the JAX
    ``AttnCache``."""
    k: torch.Tensor
    v: torch.Tensor
    pos: torch.Tensor


class QuantAttnCache(NamedTuple):
    """int8 slot-position KV cache, as the JAX ``QuantAttnCache``:
    ``k``/``v`` int8 ``[batch + 1, R, KV, hd]`` with bf16 scales
    ``[batch + 1, R, KV]``, one symmetric scale per (token, kv-head), and
    ``pos`` as in ``AttnCache``."""
    k: torch.Tensor
    v: torch.Tensor
    k_scale: torch.Tensor
    v_scale: torch.Tensor
    pos: torch.Tensor


def _dequant(c):
    """A slot cache's k and v as the attention reads them: int8 pages to
    bf16 times their bf16 scale, rounded to bf16, as JAX computes it."""
    if isinstance(c, QuantAttnCache):
        k = c.k.to(torch.bfloat16) * c.k_scale[..., None]
        v = c.v.to(torch.bfloat16) * c.v_scale[..., None]
        return k, v
    return c.k, c.v


def _rows(c, n: int):
    """The first ``n`` rows of every field of a cache tuple (views): the
    rows a batch of ``n`` reads, without the sink. A cache of ``n`` rows
    (a sharded step's, which has no sink) is returned as it is."""
    if c[0].shape[0] == n:
        return c
    return type(c)(*(a[:n] for a in c))


def _ring_size(cfg: ModelConfig, spec, max_len: int, chunk: int) -> int:
    if spec.mixer == SWA:
        return min(max_len, spec.window + chunk)
    return max_len


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, chunk: int = DEFAULT_RING_CHUNK,
               kv_quant: bool = False, device="cuda") -> Dict:
    """The zeroed slot cache on ``device``, with the arguments of the JAX
    ``init_cache``: an ``AttnCache`` (int8 ``QuantAttnCache`` with
    ``kv_quant``) of ``_ring_size`` positions per attention layer, a
    ``MambaState`` per Mamba layer, ``len`` ``[batch]`` int32 and, for an
    encoder-decoder model, ``cross``: one ``AttnCache`` of the encoder's
    ``num_positions`` per decoder layer, its ``pos`` the positions. Every
    field has ``batch + 1`` rows: row ``batch`` is the sink. Raises
    without a card unless ``device="cpu"``."""
    check_supported(cfg)
    dev = resolve_device(device)
    kv, hd, n = cfg.num_kv_heads, cfg.head_dim, batch + 1

    def zeros(shape, dt):
        return torch.zeros(shape, dtype=dt, device=dev)

    def attn_cache(r):
        pos = torch.full((n, r), -1, dtype=torch.int32, device=dev)
        if kv_quant:
            return QuantAttnCache(
                zeros((n, r, kv, hd), torch.int8),
                zeros((n, r, kv, hd), torch.int8),
                zeros((n, r, kv), torch.bfloat16),
                zeros((n, r, kv), torch.bfloat16), pos)
        return AttnCache(zeros((n, r, kv, hd), dtype),
                         zeros((n, r, kv, hd), dtype), pos)
    cache: Dict = {"layers": [
        init_mamba_state(n, cfg, dtype, dev) if spec.mixer == MAMBA
        else attn_cache(_ring_size(cfg, spec, max_len, chunk))
        for spec in cfg.layers],
        "len": torch.zeros((batch,), dtype=torch.int32, device=dev)}
    if cfg.encoder is not None:
        p = cfg.encoder.num_positions
        cache["cross"] = [
            AttnCache(zeros((n, p, kv, hd), dtype),
                      zeros((n, p, kv, hd), dtype),
                      torch.arange(p, dtype=torch.int32,
                                   device=dev).repeat(n, 1))
            for _ in range(cfg.num_layers)]
    return cache


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
    Raises without a card unless ``device="cpu"``; refuses an
    encoder-decoder model, as JAX does."""
    check_supported(cfg)
    _check_decoder_only(cfg)
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


def _write_cache(c, k_new, v_new, start_pos, valid=None,
                 rows=None) -> None:
    """Write S new tokens at global positions start_pos..start_pos+S-1,
    in place. start_pos: [B]. Ring semantics via modulo slot index.

    ``rows`` ([B], optional) is the cache row of each batch row, by
    default row ``b`` for batch row ``b``. ``valid`` ([B, S] bool,
    optional) masks bucketed-serving tail padding: pad tokens must not
    write at all (a padded decode row would wrap the ring and overwrite
    live low positions). JAX routes them to slot index R, which its
    scatter drops; here they go to the sink, the cache's last row. A
    DTensor cache is written shard by shard (``_write_cache_shards``)."""
    if is_dtensor(c.k):
        return _write_cache_shards(c, k_new, v_new, start_pos, valid)
    B, S = k_new.shape[:2]
    R = c.k.shape[1]
    dev = k_new.device
    gpos = start_pos[:, None] + torch.arange(S, device=dev)[None]   # [B, S]
    slots = gpos % R
    rows = torch.arange(B, device=dev) if rows is None else rows.long()
    rows = rows[:, None].expand(B, S)
    if valid is not None:
        rows = torch.where(valid, rows, c.k.shape[0] - 1)
    idx = (rows, slots.long())
    c.pos.index_put_(idx, gpos.to(torch.int32))
    if isinstance(c, QuantAttnCache):
        k8, ks = _quantize(k_new)
        v8, vs = _quantize(v_new)
        c.k.index_put_(idx, k8)
        c.v.index_put_(idx, v8)
        c.k_scale.index_put_(idx, ks)
        c.v_scale.index_put_(idx, vs)
        return
    c.k.index_put_(idx, k_new.to(c.k.dtype))
    c.v.index_put_(idx, v_new.to(c.v.dtype))


def _write_cache_shards(c, k_new, v_new, start_pos, valid) -> None:
    """``_write_cache`` into a DTensor cache (a sharded step's: no sink
    row, each field ``[B, R, ...]`` sharded on its batch and slot dims):
    each rank writes the slots of its own shard, in place. Slot ``r`` of
    row ``b`` takes token ``s = (r - start_pos[b]) mod R`` where ``s <
    S`` (and ``valid[b, s]``), the token that ``_write_cache``'s scatter
    puts there; the others keep their value. A select over the shard,
    not a scatter, because DTensor has no sharding of an in-place
    scatter over sharded dims; the bits are the scatter's. The new
    tokens are gathered to every rank of the slot axes first (their
    bytes are the tokens', not the cache's). A chunk longer than the ring
    would map two tokens to one slot, which this select does not order
    as the scatter does, so it is refused."""
    S, R = k_new.shape[1], c.k.shape[1]
    assert S <= R, f"a chunk of {S} tokens overruns the cache's ring of {R}"
    mesh, pls = c.k.device_mesh, c.k.placements
    rows = tuple(Shard(0) if isinstance(p, Shard) and p.dim == 0
                 else Replicate() for p in pls)

    def local(t):
        return t.redistribute(mesh, rows).to_local() if is_dtensor(t) \
            else t
    kn, vn, sp = local(k_new), local(v_new), local(start_pos)
    slot0 = local_offset(c.k)[1]
    loc = type(c)(*(f.to_local() for f in c))
    r = slot0 + torch.arange(loc.k.shape[1], device=kn.device)
    s = (r[None, :] - sp[:, None].long()) % R             # [b, r_loc]
    hit = s < S
    s = torch.where(hit, s, 0)
    if valid is not None:
        hit = hit & torch.gather(local(valid), 1, s)
    loc.pos.copy_(torch.where(hit, (sp[:, None] + s).to(torch.int32),
                              loc.pos))
    if isinstance(c, QuantAttnCache):
        (kn, ks), (vn, vs) = _quantize(kn), _quantize(vn)
        pairs = ((loc.k, kn), (loc.v, vn), (loc.k_scale, ks),
                 (loc.v_scale, vs))
    else:
        pairs = ((loc.k, kn.to(loc.k.dtype)), (loc.v, vn.to(loc.v.dtype)))
    for dst, src in pairs:
        idx = s.reshape(*s.shape, *(1,) * (src.dim() - 2)).expand(
            *s.shape, *src.shape[2:])
        m = hit.reshape(*hit.shape, *(1,) * (src.dim() - 2))
        dst.copy_(torch.where(m, torch.gather(src, 1, idx), dst))


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

def _qkv(p: Attention, cfg: ModelConfig, x, start_pos):
    """The projections of x ([B, S, d]) at positions ``start_pos[b] +
    i``, RoPE applied to q and k: (q, k, v, the positions [B, S])."""
    S = x.shape[1]
    q = einsum("bsd,dhk->bshk", x, p.wq)
    k = einsum("bsd,dhk->bshk", x, p.wk)
    v = einsum("bsd,dhk->bshk", x, p.wv)
    qpos = start_pos[:, None] + torch.arange(S, device=x.device)[None]
    return (apply_rope(q, qpos, cfg.rope_theta),
            apply_rope(k, qpos, cfg.rope_theta), v, qpos)


def _attn_paged(p: Attention, cfg: ModelConfig, spec, x,
                cache: PagedAttnCache, bt, start_pos, lens, valid,
                decode: bool, shard=_identity_shard):
    """Cached attention over the paged pool: write through the block
    table, then read, as the JAX kernel branch does. Decode rows of a
    full-attention layer go to ``paged_attention`` with the block table
    (no gather); prefill rows, and the decode rows of a sliding-window
    layer (``spec.mixer == SWA``), to ``chunked_prefill_attention`` over
    the gathered view with per-row offsets and the layer's window. Int8
    pages hand their scale pages to the decode kernel's fused-dequant
    variant (exact fp32 dequantization); the other reads take the view
    that ``_paged_view`` dequantized in bf16, cast to q's dtype
    (lossless), as JAX's prefill kernel reads it in fp32. On a
    tensor-parallel rank the heads are the rank's (the kernels read H and
    KV from their tensors); ``shard(o, "tp_heads")`` gathers every rank's
    heads before the replicated ``wo``."""
    q, k, v, _ = _qkv(p, cfg, x, start_pos)
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
    o = shard(o, "tp_heads")
    return torch.einsum("bshk,hkd->bsd", o, p.wo)


def _attn_pallas(p: Attention, cfg: ModelConfig, spec, x, cache: AttnCache,
                 start_pos, lens, valid, decode: bool, rows=None,
                 shard=_identity_shard):
    """Cached attention over the dense slot cache in the fused step, as
    the JAX ``_attn_pallas``: the write is ``_write_cache`` (into rows
    ``rows``, by default the slots ``0..B-1``), the read goes through the
    kernels. Decode rows of a full-attention layer go to
    ``paged_attention`` over the slots' rows cut into pages of
    ``min(R, 256)`` tokens when R is a multiple of that, a view of the
    cache (each slot's pages in order, so its block table is an iota);
    every other read to ``chunked_prefill_attention`` in its dynamic mode
    over R positions, the prefill rows over their slots' rows gathered
    after the write (pad rows gather the sink row, read with length 0).
    ``shard``: as in ``_attn_paged``."""
    B = x.shape[0]
    q, k, v, _ = _qkv(p, cfg, x, start_pos)
    _write_cache(cache, k, v, start_pos, valid=valid, rows=rows)
    window = spec.window if spec.mixer == SWA else None
    kv_lens = (start_pos + lens).to(torch.int32)     # valid cache extent
    R = cache.k.shape[1]
    if decode and window is None and R % min(R, 256) == 0:
        page = min(R, 256)
        n_pages = R // page
        # a view, never a copy: the slots' rows are contiguous
        k_pages = cache.k[:B].view(B * n_pages, page, *cache.k.shape[2:])
        v_pages = cache.v[:B].view(B * n_pages, page, *cache.v.shape[2:])
        bt = torch.arange(B * n_pages, dtype=torch.int32,
                          device=x.device).view(B, n_pages)
        o = ops.paged_attention(q[:, 0], k_pages, v_pages, bt,
                                kv_lens)[:, None]
    else:
        if rows is None:
            kc, vc = cache.k[:B], cache.v[:B]
        else:
            kc, vc = cache.k[rows.long()], cache.v[rows.long()]
        o = ops.chunked_prefill_attention(
            q, kc, vc, window=window, q_offsets=start_pos.to(torch.int32),
            kv_lens=kv_lens)
    o = shard(o, "tp_heads")
    return torch.einsum("bshk,hkd->bsd", o, p.wo)


def _apply_ffn(p: Layer, cfg: ModelConfig, spec, x,
               moe_impl: str = "dropless", train: bool = False,
               shard=_identity_shard):
    """The layer's FFN with its residual. A MoE layer serves through
    ``MOE_IMPLS[moe_impl]``: dropless by default, as JAX's ``_apply_ffn``
    with ``serve=True``; the fused engine passes its own. Dense weights
    are cast to x's dtype, as in JAX (the encoder runs on fp32 frames).
    ``train``: a MoE layer runs the capacity dispatch ``moe_forward``,
    and the result is ``(x, aux)`` with its metrics (``{}`` for the
    others), as JAX's ``_apply_ffn`` without ``serve``. ``shard``: the
    forward's seam, which the serving dense FFN (``tp_ffn``) and MoE
    (``tp_expert_ids``, ``tp_experts``) call, and the training MoE
    (``moe_group``, ``expert_buffer``, ``tokens``); the training dense
    FFN does not, as in JAX."""
    aux: Dict = {}
    if spec.ffn == NONE:
        return (x, aux) if train else x
    h = shard(rmsnorm(x, p.norm2, cfg.norm_eps), "gathered")
    if spec.ffn == MOE:
        if train:
            out, aux = moe_forward(p.moe, h, cfg, constrain=shard)
        else:
            out = MOE_IMPLS[moe_impl](p.moe, h, cfg, shard)
    else:
        f = p.ffn
        out = swiglu(h, f.w_gate.to(x.dtype), f.w_up.to(x.dtype),
                     f.w_down.to(x.dtype), None if train else shard)
    return (x + out, aux) if train else x + out


def _embed(params: Transformer, cfg: ModelConfig, tokens,
           frontend_embeds=None, shard=_identity_shard):
    """The token embeddings; with a vision frontend and its stub
    ``frontend_embeds`` ([B, n, d]), the leading ``n`` positions carry
    the patch embeddings instead. Where the chunk is shorter than ``n``
    JAX's ``dynamic_update_slice`` refuses; here its leading positions
    take the first patches, as the fused path's mask zeroes them. The
    lookup is ``F.embedding``, whose backward adds a row's gradients in
    a fixed order (the index op's backward, ``index_put_`` with
    ``accumulate``, does not, even on the CPU), so a training step is
    reproducible bit for bit. Two points of the ``shard`` seam that JAX
    does not have: the table passes ``shard(table, "embed_table")``
    before the lookup and the rows ``shard(x, "embedded")`` after it. A
    sharded program gathers the table's data-axis (FSDP) shards at the
    first and reduces the lookup's partial rows (a vocab-sharded table
    gives each rank the rows of its own vocabulary slice) at the second:
    DTensor's lookup takes neither a table sharded on two axes nor a
    reduction of those partial rows straight into a sharded layout."""
    x = torch.nn.functional.embedding(tokens.long(),
                                      shard(params.embed, "embed_table"))
    x = shard(x, "embedded")
    if frontend_embeds is not None and cfg.frontend is not None \
            and cfg.frontend.kind == "vision":
        n = min(frontend_embeds.shape[1], x.shape[1])
        x[:, :n] = frontend_embeds[:, :n].to(x.dtype)
    return x


def _lm_head(params: Transformer, cfg: ModelConfig, x,
             shard=_identity_shard):
    """The head's product; its weight passes ``shard(w, "weight")`` (see
    ``_weights``)."""
    w = params.lm_head if params.lm_head is not None else params.embed.T
    return einsum("bsd,dv->bsv", x, shard(w, "weight"))


def _weights(p: nn.Module, shard):
    """``p`` (a layer) as its forward reads it: with the identity seam
    ``p`` itself; else a mirror of its attributes whose every weight
    passed ``shard(w, "weight")``, where a sharded step gathers the
    weight's FSDP (data-axis) shards for the layer's use, as FSDP does
    (its backward reduce-scatters the gradient). A point of the port's
    own: DTensor would otherwise pick a product's layout from the
    weight's, and may split a flattened head dim the heads do not
    divide."""
    if shard is _identity_shard:
        return p
    ns = SimpleNamespace(**{n: _weights(c, shard)
                            for n, c in p.named_children()})
    for n, w in p.named_parameters(recurse=False):
        setattr(ns, n, shard(w, "weight"))
    return ns


# ================================================================ offline

def _pos_masked_attention(q, cache, qpos, window):
    """Attention with explicit slot-position masking (decode: S small),
    over rows ``[:B]`` of the cache. q: [B, S, H, D]; qpos: [B, S]."""
    B, S, H, D = q.shape
    cache = _rows(cache, B)
    KV = cache.k.shape[2]
    G = H // KV
    ck, cv = _dequant(cache)
    qf = q.reshape(B, S, KV, G, D)
    s = einsum("bqkgd,brkd->bkgqr", qf.float(),
               ck.to(q.dtype).float()) * D ** -0.5
    kvpos = cache.pos                                       # [B, R]
    mask = (kvpos[:, None, :] >= 0) & (kvpos[:, None, :] <= qpos[:, :, None])
    if window is not None:
        mask = mask & (qpos[:, :, None] - kvpos[:, None, :] < window)
    pr = _softmax_masked(s, mask[:, None, None])            # [B,1,1,S,R]
    o = einsum("bkgqr,brkd->bqkgd", pr, cv.float())
    return o.to(q.dtype).reshape(B, S, H, D)


def _pos_masked_attention_blocked(q, cache, qpos, window,
                                  block_q: int = 512):
    """Blocked variant for prefill chunks (no [S, R] score matrix of the
    whole chunk): query stripes of ``block_q`` rows, the last padded with
    masked rows, as JAX scans them."""
    B, S, H, D = q.shape
    bq = min(block_q, S)
    pad = (-S) % bq
    if pad:
        q = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, pad))
        qpos = torch.nn.functional.pad(qpos, (0, pad), value=-(10 ** 9))
    o = torch.cat([_pos_masked_attention(q[:, i:i + bq], cache,
                                         qpos[:, i:i + bq], window)
                   for i in range(0, S + pad, bq)], dim=1)
    return o[:, :S]


def _attn_cached(p: Attention, cfg: ModelConfig, spec, x, cache, start_pos,
                 decode: bool, fresh: bool = False, valid=None,
                 shard=_identity_shard):
    """Cached attention over a written cache (prefill chunk or decode).
    x: [B, S, D]; start_pos: [B]. The new tokens are written first
    (``_write_cache``, in place), then read.

    fresh=True (from-scratch full-prompt prefill, start_pos == 0):
    attention runs over the locally computed k/v and the cache is only
    written, as in JAX. The queries pass ``shard(q, "attn_q")`` (a
    point of the port's own): the attention views them as ``[.., KV, G,
    ..]``, and a sharded step gathers their heads where the kv heads do
    not divide the model axis."""
    S = x.shape[1]
    q, k, v, qpos = _qkv(p, cfg, x, start_pos)
    q = shard(q, "attn_q")
    _write_cache(cache, k, v, start_pos, valid=valid)
    window = spec.window if spec.mixer == SWA else None
    if fresh and not decode:
        if window is not None:
            o = swa_blocked_attention(q, k, v, q_offset=0, kv_len=S,
                                      window=window)
        else:
            o = blocked_attention(q, k, v, q_offset=0, kv_len=S)
    elif decode:
        o = _pos_masked_attention(q, cache, qpos, window)
    else:
        o = _pos_masked_attention_blocked(q, cache, qpos, window)
    o = shard(o, "tp_heads")
    return einsum("bshk,hkd->bsd", o, p.wo)


def _attn_train(p: Attention, cfg: ModelConfig, spec, x,
                causal: bool = True, shard=_identity_shard):
    """Cache-free attention (the encoder's, bidirectional with
    ``causal=False``). The weights are cast to x's dtype, as in JAX.
    Two points of the port's own: the queries pass ``shard(q,
    "attn_q")`` and the keys and values ``shard(t, "gathered")``; a
    sharded train step keeps the queries' sequence split as the
    residual's and gathers the keys' and values' (``_attention``)."""
    B, S, _ = x.shape
    q = einsum("bsd,dhk->bshk", x, p.wq.to(x.dtype))
    k = einsum("bsd,dhk->bshk", x, p.wk.to(x.dtype))
    v = einsum("bsd,dhk->bshk", x, p.wv.to(x.dtype))
    pos = torch.arange(S, device=x.device)
    q = shard(apply_rope(q, pos, cfg.rope_theta), "attn_q")
    k = shard(apply_rope(k, pos, cfg.rope_theta), "gathered")
    o = _attention(q, k, shard(v, "gathered"), causal,
                   spec.window if spec.mixer == SWA and causal else None)
    return einsum("bshk,hkd->bsd", o, p.wo.to(x.dtype))


def _attention(q, k, v, causal: bool, window):
    """``blocked_attention`` (``swa_blocked_attention`` with a
    ``window``) of q over the whole of k and v, from position 0. On
    DTensors each rank attends with its own query rows (``local_map``):
    its shard of the batch, of the sequence (at its own offset, which the
    causal mask reads) and of the heads, over the keys and values of its
    batch rows and kv heads, whole along the sequence. Rows are
    independent, so no collective is needed but the placement of k and
    v; their gradients are each rank's share, summed."""
    def attend(q, k, v, offset=0):
        if window is not None:
            return swa_blocked_attention(q, k, v, q_offset=offset,
                                         kv_len=k.shape[1], window=window)
        return blocked_attention(q, k, v, q_offset=offset,
                                 kv_len=k.shape[1], causal=causal)
    if not is_dtensor(q):
        return attend(q, k, v)
    mesh = q.device_mesh
    split = [p.dim if isinstance(p, Shard) else None for p in q.placements]
    kv_pl = tuple(Shard(d) if d in (0, 2) else Replicate() for d in split)
    kv_grad = tuple(Partial() if d == 1 else pl
                    for d, pl in zip(split, kv_pl))
    q_pl = tuple(Replicate() if d is None else Shard(d) for d in split)
    fn = local_map(functools.partial(attend, offset=local_offset(q)[1]),
                   out_placements=list(q_pl),
                   in_placements=(q_pl, kv_pl, kv_pl),
                   in_grad_placements=(q_pl, kv_grad, kv_grad),
                   device_mesh=mesh, redistribute_inputs=True)
    return fn(q, k, v)


def _cross_attn(p: Attention, cfg: ModelConfig, x, cc: AttnCache):
    """Decoder cross-attention over the cached encoder K/V (non-causal),
    rows ``[:B]`` of the cross cache."""
    B, S, _ = x.shape
    cc = _rows(cc, B)
    q = einsum("bsd,dhk->bshk", x, p.wq)
    KV = cc.k.shape[2]
    G = cfg.num_heads // KV
    qf = q.reshape(B, S, KV, G, cfg.head_dim)
    s = _gqa_scores(qf, cc.k.to(q.dtype)) * cfg.head_dim ** -0.5
    mask = (cc.pos >= 0)[:, None, None, None, :].expand(s.shape)
    pr = _softmax_masked(s, mask)
    o = _gqa_out(pr, cc.v).to(x.dtype).reshape(B, S, cfg.num_heads,
                                               cfg.head_dim)
    return einsum("bshk,hkd->bsd", o, p.wo)


def _encoder_forward(params: Transformer, cfg: ModelConfig, frames,
                     shard=_identity_shard):
    """Bidirectional encoder over stub frame embeddings [B, P, D], in
    the frames' dtype (fp32 from the engines' stub, as in JAX); each
    layer's output passes ``shard(x, "residual")``."""
    spec = LayerSpec(ATTN, DENSE)
    x = frames
    for p in params.encoder.layers:
        h = rmsnorm(x, p.norm1, cfg.norm_eps)
        x = x + _attn_train(p.attn, cfg, spec, h, causal=False, shard=shard)
        x = shard(_apply_ffn(p, cfg, spec, x), "residual")
    return rmsnorm(x, params.encoder.final_norm, cfg.norm_eps)


def _cross_caches_train(params: Transformer, cfg: ModelConfig,
                        enc_out) -> List[AttnCache]:
    """The training forward's cross K/V, built as new tensors (autograd
    trains through them; ``_build_cross_caches`` writes into a cache in
    place). As in JAX, which builds them over the template of
    ``init_cache``'s default dtype, K and V are rounded to bf16; the
    positions are those of ``init_cache``'s cross caches."""
    B, P = enc_out.shape[:2]
    pos = torch.arange(P, dtype=torch.int32,
                       device=enc_out.device).repeat(B, 1)
    ccs = []
    for li in range(cfg.num_layers):
        p = params.layers[li].cross
        k = einsum("bpd,dhk->bphk", enc_out, p.wk.to(enc_out.dtype))
        v = einsum("bpd,dhk->bphk", enc_out, p.wv.to(enc_out.dtype))
        ccs.append(AttnCache(k=k.to(torch.bfloat16), v=v.to(torch.bfloat16),
                             pos=pos))
    return ccs


def _build_cross_caches(params: Transformer, cfg: ModelConfig, enc_out,
                        cache: Dict) -> List[AttnCache]:
    """Each decoder layer's cross K/V from the encoder output, written
    in place into rows ``[:B]`` of ``cache["cross"]`` in its dtype."""
    B = enc_out.shape[0]
    for li in range(cfg.num_layers):
        p = params.layers[li].cross
        old = cache["cross"][li]
        old.k[:B] = einsum("bpd,dhk->bphk", enc_out,
                           p.wk.to(enc_out.dtype))
        old.v[:B] = einsum("bpd,dhk->bphk", enc_out,
                           p.wv.to(enc_out.dtype))
    return cache["cross"]


def _decoder_block(p: Layer, cfg: ModelConfig, spec, x, layer_cache,
                   start_pos, decode: bool, cross_cache=None,
                   fresh: bool = False, seq_lens=None, valid=None,
                   train: bool = False, shard=_identity_shard):
    """One layer of the offline path over rows ``[:B]`` of its cache,
    updated in place. ``valid`` ([B, 1], decode only): rows where it is
    False neither write KV nor advance their Mamba state.

    ``train``: the training forward's layer, which returns ``(x, aux)``
    (the MoE metrics) and writes nothing: cache-free attention
    (``_attn_train``), ``mamba_forward`` from ``layer_cache`` (a fresh
    state; the new one is dropped), the training ``moe_forward``. The
    block's output passes ``shard(x, "residual")``, as in JAX. The
    normed input of a Mamba mixer, the cross-attention and the FFN passes
    ``shard(h, "gathered")``, a point of the port's own: a sharded train
    step gathers the sequence-parallel residual's sequence there (and
    its backward reduce-scatters), as sequence parallelism does around
    its products; the attention keeps its queries' split
    (``_attn_train``)."""
    h = rmsnorm(x, p.norm1, cfg.norm_eps)
    if train:
        if spec.mixer == MAMBA:
            x = x + mamba_forward(p.mamba, shard(h, "gathered"), cfg,
                                  layer_cache)[0]
        else:
            x = x + _attn_train(p.attn, cfg, spec, h, shard=shard)
        if cross_cache is not None:
            hc = shard(rmsnorm(x, p.norm_cross, cfg.norm_eps), "gathered")
            x = x + _cross_attn(p.cross, cfg, hc, cross_cache)
        x, aux = _apply_ffn(p, cfg, spec, x, train=True, shard=shard)
        return shard(x, "residual"), aux
    if spec.mixer == MAMBA:
        st = _rows(layer_cache, x.shape[0])
        if decode:
            out, new = mamba_step(p.mamba, h, cfg, st)
        else:
            out, new = mamba_forward(p.mamba, h, cfg, st, seq_lens=seq_lens)
        if valid is not None:
            new = MambaState(
                conv=torch.where(valid[:, :, None], new.conv.to(st.conv.dtype),
                                 st.conv),
                ssm=torch.where(valid[:, :, None, None], new.ssm, st.ssm))
        st.conv.copy_(new.conv)
        st.ssm.copy_(new.ssm)
        x = x + out
    else:
        x = x + _attn_cached(p.attn, cfg, spec, h, layer_cache, start_pos,
                             decode, fresh=fresh, valid=valid, shard=shard)
    if cross_cache is not None:
        hc = rmsnorm(x, p.norm_cross, cfg.norm_eps)
        x = x + _cross_attn(p.cross, cfg, hc, cross_cache)
    return shard(_apply_ffn(p, cfg, spec, x, shard=shard), "residual")


def forward_train(params: Transformer, cfg: ModelConfig, batch: Dict,
                  shard=_identity_shard, remat: bool = True):
    """The training forward, as the JAX ``forward_train``. batch:
    ``{"tokens": [B, S]}``, with ``"frontend_embeds"`` ([B, n, d], the
    vision stub) or ``"frames"`` ([B, P, d], an encoder-decoder model's
    stub frames). Returns (logits [B, S, Vp], aux): aux holds each MoE
    metric averaged over ``cfg.num_layers``.

    Differentiable in the parameters (the trainer turns their
    ``requires_grad`` on) and never under ``inference_mode``: it writes no
    cache (a Mamba layer starts from a fresh zero state, an
    encoder-decoder model's cross K/V are new tensors). ``remat``: each
    layer runs under ``torch.utils.checkpoint`` (non-reentrant), which
    keeps its input and recomputes the rest in the backward pass, as
    ``jax.checkpoint`` does; the result is the same, bit for bit.
    ``shard``: the ``shard(t, kind)`` seam of a sharded step
    (``distributed.sharding.ShardingRules.shard_fn``), called at JAX's
    points: ``"residual"`` after the embedding and each block,
    ``"logits"`` on the head."""
    tokens = batch["tokens"]
    x = _embed(params, cfg, tokens, batch.get("frontend_embeds"), shard)
    x = shard(x, "residual")
    cross = None
    if cfg.is_encdec:
        enc_out = _encoder_forward(params, cfg, batch["frames"], shard)
        cross = _cross_caches_train(params, cfg, enc_out)
    aux_all: Dict = {}
    for li, spec in enumerate(cfg.layers):
        state = init_mamba_state(tokens.shape[0], cfg, x.dtype, x.device) \
            if spec.mixer == MAMBA else None
        cc = cross[li] if cross is not None else None

        def block(x, p=params.layers[li], spec=spec, state=state, cc=cc):
            return _decoder_block(_weights(p, shard), cfg, spec, x, state,
                                  None, decode=False, cross_cache=cc,
                                  train=True, shard=shard)

        if remat:
            x, aux = checkpoint(block, x, use_reentrant=False)
        else:
            x, aux = block(x)
        for k, v in aux.items():
            aux_all[k] = aux_all.get(k, 0.0) + v / cfg.num_layers
    x = rmsnorm(x, params.final_norm, cfg.norm_eps)
    return shard(_lm_head(params, cfg, x, shard), "logits"), aux_all


def _offline(fn):
    """Run ``fn(params, ...)`` under ``torch.inference_mode()``, or under
    ``torch.no_grad()`` where the parameters are DTensors (a sharded
    step): a DTensor's views cannot be made in inference mode. Neither
    changes a number."""
    @functools.wraps(fn)
    def run(params, *args, **kwargs):
        with torch.no_grad() if is_dtensor(params.embed) \
                else torch.inference_mode():
            return fn(params, *args, **kwargs)
    return run


@_offline
def prefill(params: Transformer, cfg: ModelConfig, cache: Dict, tokens,
            start_pos, batch_extras=None, fresh: bool = False,
            seq_lens=None, shard=_identity_shard):
    """Process a prefill chunk. tokens: [B, S]; start_pos: [B] (= current
    cache lengths); rows ``[:B]`` of ``cache`` are updated in place and
    ``cache["len"][:B]`` advances by S. ``fresh``: from-scratch
    full-prompt prefill (start_pos == 0, empty cache). ``seq_lens`` ([B],
    optional): true row lengths when the tail is bucket padding (pad
    tokens must not advance Mamba recurrences; attention-side padding is
    the caller's length bookkeeping). ``batch_extras``: the stubs'
    ``frontend_embeds`` and, for an encoder-decoder model, ``frames``,
    which run the encoder and rebuild the cross caches. ``shard``: as in
    ``forward_train``. Returns (logits [B, S, Vp], cache)."""
    batch_extras = batch_extras or {}
    x = _embed(params, cfg, tokens, batch_extras.get("frontend_embeds"),
               shard)
    x = shard(x, "residual")
    if cfg.is_encdec and "frames" in batch_extras:
        enc_out = _encoder_forward(params, cfg, batch_extras["frames"],
                                   shard)
        _build_cross_caches(params, cfg, enc_out, cache)
    for li, spec in enumerate(cfg.layers):
        cc = cache["cross"][li] if cfg.is_encdec else None
        x = _decoder_block(params.layers[li], cfg, spec, x,
                           cache["layers"][li], start_pos, decode=False,
                           cross_cache=cc, fresh=fresh, seq_lens=seq_lens,
                           shard=shard)
    x = rmsnorm(x, params.final_norm, cfg.norm_eps)
    logits = shard(_lm_head(params, cfg, x), "logits")
    cache["len"][:tokens.shape[0]] += tokens.shape[1]
    return logits, cache


@_offline
def decode_step(params: Transformer, cfg: ModelConfig, cache: Dict, token,
                active=None, shard=_identity_shard):
    """One decode iteration. token: [B, 1] (last sampled token), at
    positions ``cache["len"][:B]``. ``active`` ([B] bool, optional):
    rows where it is False compute but neither write KV, nor advance
    their Mamba state or length (their writes go to the sink), the
    in-place form of the JAX reference engine's post-step select.
    ``shard``: as in ``forward_train`` (nothing after the embedding, as
    in JAX). Returns (logits [B, 1, Vp], cache)."""
    B = token.shape[0]
    start_pos = cache["len"][:B].clone()
    valid = None if active is None else active[:, None]
    x = _embed(params, cfg, token, shard=shard)
    for li, spec in enumerate(cfg.layers):
        cc = cache["cross"][li] if cfg.is_encdec else None
        x = _decoder_block(params.layers[li], cfg, spec, x,
                           cache["layers"][li], start_pos, decode=True,
                           cross_cache=cc, valid=valid, shard=shard)
    x = rmsnorm(x, params.final_norm, cfg.norm_eps)
    logits = shard(_lm_head(params, cfg, x), "logits")
    cache["len"][:B] += 1 if active is None else active.to(torch.int32)
    return logits, cache


# ================================================================ fused


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
                 moe_impl: str = "grouped", shard=_identity_shard):
    """One layer of the fused serve iteration: the prefill sub-batch
    ([P, L] chunk rows) and the decode sub-batch ([N, 1]) advance
    together; a request is in one of them only, so their page writes
    and state updates touch disjoint pages and slots. An absent
    sub-batch (size 0) is skipped, as JAX traces no machinery for it.
    The layer's cache (pages, slot rows or Mamba state) is updated in
    place: a paged cache through the block tables (``_attn_paged``), a
    dense one by slot (``_attn_pallas``; the decode sub-batch is the
    slots ``0..N-1``)."""
    if spec.mixer == MAMBA:
        x_pre, x_dec = _mamba_block(p, cfg, x_pre, x_dec, layer_cache,
                                    pre_slots, pre_len, pre_reset,
                                    dec_active)
    elif isinstance(layer_cache, AttnCache):
        if x_pre.shape[0]:
            h = rmsnorm(x_pre, p.norm1, cfg.norm_eps)
            x_pre = x_pre + _attn_pallas(p.attn, cfg, spec, h, layer_cache,
                                         pre_start, pre_len, pre_valid,
                                         False, rows=pre_slots, shard=shard)
        if x_dec.shape[0]:
            h = rmsnorm(x_dec, p.norm1, cfg.norm_eps)
            x_dec = x_dec + _attn_pallas(
                p.attn, cfg, spec, h, layer_cache, dec_start,
                dec_active.to(dec_start.dtype), dec_active[:, None], True,
                shard=shard)
    else:
        if x_pre.shape[0]:
            h = rmsnorm(x_pre, p.norm1, cfg.norm_eps)
            x_pre = x_pre + _attn_paged(p.attn, cfg, spec, h, layer_cache,
                                        pre_bt, pre_start, pre_len,
                                        pre_valid, False, shard)
        if x_dec.shape[0]:
            h = rmsnorm(x_dec, p.norm1, cfg.norm_eps)
            x_dec = x_dec + _attn_paged(
                p.attn, cfg, spec, h, layer_cache, dec_bt, dec_start,
                dec_active.to(dec_start.dtype), dec_active[:, None], True,
                shard)
    if x_pre.shape[0]:
        x_pre = _apply_ffn(p, cfg, spec, x_pre, moe_impl, shard=shard)
    if x_dec.shape[0]:
        x_dec = _apply_ffn(p, cfg, spec, x_dec, moe_impl, shard=shard)
    return x_pre, x_dec


def _sampled_hidden(params: Transformer, cfg: ModelConfig, cache: Dict,
                    pre_tokens, pre_slots, pre_start, pre_len, pre_reset,
                    pre_sample_col, dec_tokens, dec_start, dec_active,
                    pre_bt, dec_bt, moe_impl: str = "grouped",
                    shard=_identity_shard):
    """Every layer of one fused iteration, then the final norm of the
    rows that are sampled: ``[P + N, d]``, prefill rows (their
    ``pre_sample_col`` column) then decode slots. This is what the LM
    head reads."""
    P, L = pre_tokens.shape
    x_pre = _embed(params, cfg, pre_tokens)
    x_dec = _embed(params, cfg, dec_tokens[:, None])
    if P and cfg.frontend is not None and cfg.frontend.kind == "vision":
        # the stub frontend, as the reference engine's: the leading
        # positions of each prefill chunk carry (zero) patch embeddings
        x_pre[:, :cfg.frontend.num_tokens] = 0.0
    pre_valid = torch.arange(L, device=pre_len.device)[None] \
        < pre_len[:, None]
    for li, spec in enumerate(cfg.layers):
        x_pre, x_dec = _fused_block(
            params.layers[li], cfg, spec, x_pre, x_dec, cache["layers"][li],
            pre_slots, pre_start, pre_len, pre_reset, pre_valid, dec_start,
            dec_active, pre_bt, dec_bt, moe_impl, shard)
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
                        moe_impl: str = "grouped",
                        shard=_identity_shard) -> torch.Tensor:
    """ONE fused serve iteration executing a whole BatchPlan, with greedy
    sampling on the device. The arguments are those of the JAX
    ``fused_serve_forward``:

      pre_tokens [P, L] int32; pre_slots [P] int32 (each row's slot,
      ``n_slots`` for pad rows); pre_start / pre_len [P] int32 (pre_len 0
      = pad row); pre_reset [P] bool (a request's first chunk: zero its
      Mamba state); pre_sample_col [P] int32; dec_tokens / dec_start [N]
      int32, dec_active [N] bool; pre_bt [P, maxb] / dec_bt [N, maxb]
      int32 block tables (-1 = unallocated) in the paged layout, None in
      the dense one (``init_cache``); moe_impl ``"grouped"`` or
      ``"dropless"``, the MoE layers' FFN; shard the ``shard(t, kind)``
      seam: the identity on one device, on a tensor-parallel rank the
      gathers of ``TPServePlan.shard_fn`` (``tp_heads`` on each
      attention output before ``wo``, ``tp_ffn`` between the
      up-projections and ``w_down``, ``tp_expert_ids`` and
      ``tp_experts`` in the MoE, ``logits`` on the LM head's output
      before the argmax), as in JAX.

    The cache's pages, slot rows and Mamba state rows are updated in
    place. Returns the sampled ids, ``[P + N]`` int32 (prefill rows, then
    decode slots). Refuses an encoder-decoder model, as JAX does."""
    _check_decoder_only(cfg)
    xs = _sampled_hidden(params, cfg, cache, pre_tokens, pre_slots,
                         pre_start, pre_len, pre_reset, pre_sample_col,
                         dec_tokens, dec_start, dec_active, pre_bt, dec_bt,
                         moe_impl, shard)
    w = params.lm_head if params.lm_head is not None else params.embed.T
    logits = shard(xs @ w, "logits")
    # torch.argmax, like jnp.argmax, returns the first maximum
    return torch.argmax(logits[:, :cfg.vocab_size], dim=-1).to(torch.int32)
