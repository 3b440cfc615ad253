"""Sharding rules: logical roles -> partition specs per (arch x shape x
mesh), the counterpart of the JAX package's ``distributed/sharding.py``.

The strategy is JAX's, rule for rule:

  * batch        -> data axes ("pod","data") when divisible
  * attn heads   -> "model" when head count divides the axis, else replicate
                    (llama3.2 24H / gemma3 8H on a 16-way axis)
  * kv heads     -> replicated (GQA kv counts < axis size), EXCEPT caches,
                    whose seq dim shards instead
  * d_ff / vocab / experts / mamba inner dims -> "model"
  * residual stream (train) -> seq on "model" (sequence parallelism)
  * KV cache: decode shards cache seq on "model" (batch on data);
    long-context (batch=1) shards cache seq on BOTH axes
  * train params: FSDP -- d_model dim additionally sharded on the data axes
  * MoE expert buffers [G, E, C, D]: E on "model", the groups on data

A spec (``P``) is a tuple with one entry per dim: a mesh axis name, a
tuple of names, or None; it equals JAX's ``PartitionSpec`` as a tuple.
Parameters are named by their ``state_dict`` names (``layers.3.attn.wq``),
whose parts are the JAX tree's path. The mesh is a ``DeviceMesh``
(``launch/mesh.py``) or anything with ``axis_names`` and a ``shape``
mapping each to its size (a shape-only stand-in).

Where JAX pins a layout with ``with_sharding_constraint`` and GSPMD
inserts the collectives, the port's ``shard_fn`` redistributes a DTensor
to the kind's placements (``placements``), and DTensor's sharding
propagation inserts the rest. A plain tensor passes ``shard_fn``
untouched: the one-device program.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.mamba2 import MambaState
from repro_torch.models.transformer import (AttnCache, PagedAttnCache,
                                            QuantAttnCache,
                                            QuantPagedAttnCache)

from .torch_api import DTensor, Replicate, Shard, distribute


class P(tuple):
    """A partition spec: ``P("data", None)``. A tuple of its entries."""

    def __new__(cls, *parts):
        return tuple.__new__(cls, parts)

    def __getnewargs__(self):
        return tuple(self)

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


def axis_sizes(mesh) -> Dict[str, int]:
    """Mesh axis name -> size, for a ``DeviceMesh`` or a shape-only mesh
    (``axis_names`` and a ``shape`` mapping)."""
    names = getattr(mesh, "mesh_dim_names", None) or mesh.axis_names
    shape = mesh.shape
    if isinstance(shape, Mapping):
        return {a: int(shape[a]) for a in names}
    return dict(zip(names, (int(n) for n in shape)))


def _axsize(mesh, axes) -> int:
    if axes is None:
        return 1
    sizes = axis_sizes(mesh)
    if isinstance(axes, str):
        return sizes[axes]
    return int(np.prod([sizes[a] for a in axes]))


def _maybe(dim: int, axes, mesh):
    """axes if dim divides the (product) axis size, else None."""
    n = _axsize(mesh, axes)
    return axes if (dim % n == 0 and dim >= n) else None


def placements(spec, mesh) -> Tuple:
    """The DTensor placements of ``spec`` on ``mesh`` (the counterpart of
    ``NamedSharding(mesh, spec)``): per mesh axis, ``Shard(d)`` where dim
    ``d`` of the spec names the axis, alone or in a tuple, else
    ``Replicate()``. A dim over several axes shards them in the mesh's
    order, major to minor, as a JAX tuple of axes does."""
    out = []
    for ax in axis_sizes(mesh):
        dim = next((d for d, e in enumerate(spec)
                    if e == ax or (isinstance(e, tuple) and ax in e)), None)
        out.append(Replicate() if dim is None else Shard(dim))
    return tuple(out)


def fit(spec, shape, mesh) -> P:
    """``spec`` padded with None to ``len(shape)`` dims, an axis dropped
    where it does not divide its dim, as JAX's ``shard_fn`` drops it."""
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    return P(*(ax if ax is None or shape[i] % _axsize(mesh, ax) == 0
               else None for i, ax in enumerate(spec)))


class ShardingRules:
    def __init__(self, cfg: ModelConfig, mesh, train: bool,
                 fsdp: bool = True):
        self.cfg = cfg
        self.mesh = mesh
        self.train = train
        axes = tuple(axis_sizes(mesh))
        self.dp = tuple(a for a in axes if a in ("pod", "data")) or None
        if self.dp and len(self.dp) == 1:
            self.dp = self.dp[0]
        self.tp = "model" if "model" in axes else None
        # FSDP only matters for training (opt states dominate memory)
        self.fsdp_axes = self.dp if (train and fsdp) else None

    def _expert_2d(self, budget_bytes: float = 12e9) -> bool:
        cfg = self.cfg
        if cfg.moe is None:
            return False
        n_moe = sum(1 for l in cfg.layers if l.ffn == "moe")
        tp_n = _axsize(self.mesh, self.tp) if self.tp else 1
        byts = (n_moe * cfg.moe.num_experts * 3 * cfg.d_model
                * cfg.moe.d_ff_expert * 2) / tp_n
        return byts > budget_bytes

    # ----------------------------------------------------------- params
    def param_spec(self, path: Tuple[str, ...], leaf) -> P:
        cfg, mesh = self.cfg, self.mesh
        name = path[-1]
        fs = self.fsdp_axes
        d_model_fsdp = _maybe(cfg.d_model, fs, mesh) if fs else None

        if name == "embed":
            return P(_maybe(cfg.vocab_padded, self.tp, mesh), d_model_fsdp)
        if name == "lm_head":
            if self.train:
                # train shards LOGITS on seq ("model"), so the head weight
                # keeps vocab whole (d_model FSDP-sharded instead)
                return P(d_model_fsdp, None)
            return P(None, _maybe(cfg.vocab_padded, self.tp, mesh))
        if name in ("norm1", "norm2", "norm_cross", "final_norm", "norm_w",
                    "conv_b", "A_log", "D", "dt_bias"):
            return P(None)
        if name == "wq":
            return P(d_model_fsdp, _maybe(cfg.num_heads, self.tp, mesh), None)
        if name in ("wk", "wv"):
            return P(d_model_fsdp,
                     _maybe(cfg.num_kv_heads, self.tp, mesh), None)
        if name == "wo":
            return P(_maybe(cfg.num_heads, self.tp, mesh), None, d_model_fsdp)
        if name in ("w_gate", "w_up", "w_down") and len(path) >= 2 \
                and path[-2] == "moe":
            e = _maybe(cfg.moe.num_experts, self.tp, mesh)
            # 2D expert sharding at inference when 1D does not fit HBM
            # (dbrx: 264 GB of experts / 16 = 16.5 GB > budget): also
            # shard d_ff over the data axes
            f_axes = fs
            if not self.train and self._expert_2d():
                f_axes = self.dp
            f_spec = _maybe(cfg.moe.d_ff_expert, f_axes, mesh) \
                if f_axes else None
            if name == "w_down":
                return P(e, f_spec, None)
            return P(e, None, f_spec)
        if name == "router":
            return P(d_model_fsdp, _maybe(cfg.moe.num_experts, self.tp, mesh))
        if name in ("w_gate", "w_up"):        # dense swiglu
            return P(d_model_fsdp, _maybe(cfg.d_ff, self.tp, mesh))
        if name == "w_down":
            return P(_maybe(cfg.d_ff, self.tp, mesh), d_model_fsdp)
        # --- mamba ---
        if cfg.ssm is not None:
            s = cfg.ssm
            d_in = s.d_inner(cfg.d_model)
            conv_dim = d_in + 2 * s.d_state
            nh = s.n_heads(cfg.d_model)
            if name == "w_z":
                return P(d_model_fsdp, _maybe(d_in, self.tp, mesh))
            if name == "w_xBC":
                return P(d_model_fsdp, _maybe(conv_dim, self.tp, mesh))
            if name == "w_dt":
                return P(d_model_fsdp, _maybe(nh, self.tp, mesh))
            if name == "conv_w":
                return P(None, _maybe(conv_dim, self.tp, mesh))
            if name == "out_proj":
                return P(_maybe(d_in, self.tp, mesh), d_model_fsdp)
        return P()

    def param_specs(self, params) -> Dict[str, P]:
        """``state_dict`` name -> spec, for a ``Transformer`` (any
        ``nn.Module``) or a dict of tensors by name."""
        named = params.named_parameters() \
            if isinstance(params, torch.nn.Module) else params.items()
        return {n: self.param_spec(tuple(n.split(".")), t)
                for n, t in named}

    # ----------------------------------------------------------- activations
    def act_spec(self, kind: str) -> P:
        if kind == "residual":
            if self.train:
                return P(self.dp, self.tp, None)     # seq-parallel residual
            return P(self.dp, None, None)
        if kind == "expert_buffer":   # [G, E, C, D]
            e = _maybe(self.cfg.moe.num_experts, self.tp, self.mesh) \
                if self.cfg.moe else None
            return P(self.dp, e, None, None)
        if kind == "moe_group":       # [G, Tg, D]
            return P(self.dp, None, None)
        if kind == "tokens":
            return P(self.dp, None, None)
        if kind == "logits":
            if self.train:
                return P(self.dp, self.tp, None)     # seq-sharded
            return P(self.dp, None, self.tp)         # vocab-sharded
        # points of the port's own (no JAX counterpart; see
        # ``models/transformer._embed`` and ``_decoder_block``): the table
        # at the lookup, its FSDP shards gathered; the looked-up rows,
        # whose partial sums over a vocab-sharded table are reduced over
        # the model axis; a block's normed input (and the keys and values
        # of a train step's attention), its sequence gathered; the queries
        # at the attention: in training split on the sequence as the
        # residual, in serving on the heads only where the kv heads are
        # (the GQA view [.., KV, G, ..] splits KV); the labels, split as
        # the logits' rows, so that the gold logit's gather stays local
        if kind == "embed_table":     # [Vp, D]
            return P(_maybe(self.cfg.vocab_padded, self.tp, self.mesh), None)
        if kind in ("embedded", "gathered"):        # [B, S, D]
            return P(self.dp, None, None)
        if kind == "labels":          # [B, S]: as the logits' rows
            return P(self.dp, self.tp if self.train else None)
        if kind == "attn_q":          # [B, S, H, hd]
            if self.train:            # the sequence split as the residual's
                return P(self.dp, self.tp, None, None)
            kv = _maybe(self.cfg.num_kv_heads, self.tp, self.mesh)
            return P(self.dp, None, kv and _maybe(self.cfg.num_heads, kv,
                                                  self.mesh), None)
        return P()

    def shard_fn(self):
        """The ``shard(t, kind)`` hook of the steps: a DTensor is
        redistributed to ``act_spec(kind)`` on its own mesh, an axis
        dropped where it does not divide its dim, and a ``"weight"`` to
        its own placements with the data axes' shards gathered; a ``tp_``
        kind (the tensor-parallel serve gathers) and a plain tensor pass
        through."""
        dp = (self.dp,) if isinstance(self.dp, str) else (self.dp or ())

        def shard(t, kind):
            if kind.startswith("tp_") or not isinstance(t, DTensor):
                return t
            mesh = t.device_mesh
            if kind == "weight":      # a weight at its use: FSDP gathered
                want = tuple(Replicate() if ax in dp else pl for ax, pl in
                             zip(mesh.mesh_dim_names, t.placements))
            else:
                spec = fit(self.act_spec(kind), t.shape, mesh)
                want = placements(spec, mesh)
            if tuple(t.placements) == want:
                return t
            return t.redistribute(mesh, want)

        return shard

    # ----------------------------------------------------------- batch/cache
    def batch_spec(self, global_batch: int) -> Optional[Any]:
        return _maybe(global_batch, self.dp, self.mesh)

    def data_specs(self, batch_shapes: Dict[str, Tuple[int, ...]]) -> Dict:
        """Specs for token-level inputs: dict name -> P."""
        out = {}
        for name, shp in batch_shapes.items():
            b = self.batch_spec(shp[0])
            out[name] = P(b, *([None] * (len(shp) - 1)))
        return out

    def cache_specs(self, cache, global_batch: int, long_context: bool):
        """Specs mirroring an ``init_cache`` / ``init_paged_cache`` dict,
        each layer's tuple of the same type with a spec per field.

        decode_32k: batch on data axes, cache seq on "model".
        long_500k (batch=1): cache seq on ALL axes (data+model combined).
        The batch dim of ``init_cache``'s fields holds the sink row
        besides the batch; its spec is the batch's."""
        mesh = self.mesh
        b_ax = self.batch_spec(global_batch)
        if long_context and b_ax is None:
            seq_axes_all = tuple(axis_sizes(mesh))
        else:
            seq_axes_all = None

        def paged_spec(c):
            # pools [num_blocks, bs, KV, hd] have no batch dim: the kv-head
            # axis shards on "model" when it divides, else all replicates
            kv_ax = _maybe(c.k.shape[2], self.tp, mesh)
            if isinstance(c, QuantPagedAttnCache):
                return QuantPagedAttnCache(
                    k=P(None, None, kv_ax, None),
                    v=P(None, None, kv_ax, None),
                    k_scale=P(None, None, kv_ax),
                    v_scale=P(None, None, kv_ax))
            return PagedAttnCache(k=P(None, None, kv_ax, None),
                                  v=P(None, None, kv_ax, None))

        def kv_spec(c):
            R = c.k.shape[1]
            if seq_axes_all is not None:
                seq_ax = _maybe(R, seq_axes_all, mesh) or \
                    _maybe(R, self.tp, mesh)
            else:
                seq_ax = _maybe(R, self.tp, mesh)
            if isinstance(c, QuantAttnCache):
                return QuantAttnCache(
                    k=P(b_ax, seq_ax, None, None),
                    v=P(b_ax, seq_ax, None, None),
                    k_scale=P(b_ax, seq_ax, None),
                    v_scale=P(b_ax, seq_ax, None),
                    pos=P(b_ax, seq_ax))
            return AttnCache(
                k=P(b_ax, seq_ax, None, None),
                v=P(b_ax, seq_ax, None, None),
                pos=P(b_ax, seq_ax))

        def mamba_spec(st: MambaState) -> MambaState:
            nh = st.ssm.shape[1]
            return MambaState(
                conv=P(b_ax, None, _maybe(st.conv.shape[-1], self.tp, mesh)),
                ssm=P(b_ax, _maybe(nh, self.tp, mesh), None, None))

        layers = []
        for st in cache["layers"]:
            if isinstance(st, MambaState):
                layers.append(mamba_spec(st))
            elif isinstance(st, (PagedAttnCache, QuantPagedAttnCache)):
                layers.append(paged_spec(st))
            else:
                layers.append(kv_spec(st))
        out = {"layers": layers}
        if "len" in cache:
            out["len"] = P(b_ax)
        if "cross" in cache:
            out["cross"] = [AttnCache(k=P(b_ax, None, None, None),
                                      v=P(b_ax, None, None, None),
                                      pos=P(b_ax, None))
                            for _ in cache["cross"]]
        return out

    def logits_spec(self, global_batch: int) -> P:
        return P(self.batch_spec(global_batch), None,
                 _maybe(self.cfg.vocab_padded, self.tp, self.mesh))


# ------------------------------------------------------------ placing


def place_params(params: torch.nn.Module, specs: Dict[str, P],
                 mesh) -> Dict[str, Tuple]:
    """Make every parameter of ``params`` (a ``Transformer``) a DTensor
    placed by its spec on ``mesh`` (a ``DeviceMesh``), in place; each
    rank keeps its slice. Returns name -> placements: the train step's
    ``grad_shardings``."""
    from repro_torch.models.transformer import _assign
    out = {}
    for name, p in list(params.named_parameters()):
        out[name] = placements(specs[name], mesh)
        _assign(params, name, distribute(p.detach(), mesh, out[name]))
    return out


def place_cache(cache: Dict, specs: Dict, mesh, batch: int) -> Dict:
    """An ``init_cache`` dict as DTensors placed by ``cache_specs``, the
    sink row of every batched field dropped: a sharded step writes no
    sink (``transformer._write_cache_shards``), and the batch dim then
    divides as the spec says. An ``init_paged_cache`` dict keeps its
    pools whole."""
    def put(t, spec, batched):
        return distribute(t[:batch] if batched else t, mesh,
                          placements(spec, mesh))

    def tup(c, sp):
        batched = not isinstance(c, (PagedAttnCache, QuantPagedAttnCache))
        return type(c)(*(put(f, s, batched) for f, s in zip(c, sp)))
    out = {"layers": [tup(c, sp) for c, sp in zip(cache["layers"],
                                                   specs["layers"])]}
    if "len" in cache:
        out["len"] = put(cache["len"], specs["len"], True)
    if "cross" in cache:
        out["cross"] = [tup(c, sp) for c, sp in zip(cache["cross"],
                                                     specs["cross"])]
    return out


def place_batch(batch: Dict[str, torch.Tensor], specs: Dict[str, P],
                mesh) -> Dict:
    """The token-level inputs as DTensors placed by ``data_specs``."""
    return {k: distribute(v, mesh, placements(specs[k], mesh))
            for k, v in batch.items()}
