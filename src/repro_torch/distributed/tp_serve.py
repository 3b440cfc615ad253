"""Tensor-parallel serve plan over ``torch.distributed``: the counterpart
of the JAX package's ``distributed/tp_serve.py`` (docs/engine.md
§Sharded serve).

JAX runs one controller over a device mesh and lowers the fused step
through ``shard_map``. Here every rank is a process of its own that holds
its shard and runs the port's kernels on it; ``TorchEngine(tp=N)`` is
rank 0 and spawns ranks 1..N-1 (``distributed/worker.py``). The design
contract is JAX's:

* Only non-contracted output dims shard: the q/k/v head axes, the dense
  swiglu d_ff axis, the MoE expert axis, the lm_head vocab axis and the
  caches' kv-head axis. A rank's slice of a GEMM's output columns is the
  same slice of the single-device product wherever the library keeps its
  reduction over the contracted dim (the CPU at the tests' reduced
  widths; not always on the card at full width, where cuBLAS picks its
  kernel by shape).
* Every combine (``wo``, ``w_down``, the MoE weighted sum, the greedy
  argmax) runs replicated on an all-gathered tensor, never as a sharded
  contraction plus an all-reduce, whose reassociation changes the bits.
* ``wo``, ``w_down``, the router, the embedding, the norms and the Mamba
  parameters are replicated. ``TPGroup.all_gather`` concatenates the
  ranks' slices in rank order: data movement, no arithmetic.

The hooks ride the serve forward's ``shard(t, kind)`` seam
(``models/transformer.py``); unknown kinds pass through, and a dim that
does not divide ``tp`` replicates, its hook the identity.
"""
from __future__ import annotations

import dataclasses
import datetime
from typing import Callable, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

from repro_torch.models.config import MAMBA, ModelConfig

# seconds a rendezvous or a collective may wait for the other ranks
TIMEOUT_S = 60.0


def pick_backend(device: torch.device, tp: int) -> str:
    """The collective backend of a ``tp``-rank group whose rank 0 runs on
    ``device``: ``"gloo"`` on the CPU, or when the ranks share the one
    card there is (gloo carries CUDA tensors; NCCL refuses two ranks on
    one device); ``"nccl"`` when each rank has a card of its own. Any
    other case raises. Prints the choice."""
    if device.type == "cpu":
        backend, why = "gloo", f"{tp} ranks on the CPU"
    elif device.type == "cuda":
        n = torch.cuda.device_count()
        if n >= tp:
            backend, why = "nccl", f"{tp} ranks on {tp} of {n} cards"
        elif n == 1:
            backend, why = "gloo", f"{tp} ranks share one card"
        else:
            raise ValueError(f"tp={tp} over {n} cards: each rank needs a "
                             f"card of its own, or all share one")
    else:
        raise ValueError(f"tensor parallelism on device {device}: the CPU "
                         f"or CUDA only")
    print(f"[tp] backend {backend}: {why}")
    return backend


class TPGroup:
    """One rank's membership of a ``size``-rank group: its rank, the
    backend and the process group, built directly on a file store (no
    default group, so one process may hold several engines' groups).
    Every rendezvous and collective gives up after ``TIMEOUT_S`` seconds.

    ``all_gather`` is the one collective of the serve path; it counts the
    bytes this rank received, by the plan's op name."""

    def __init__(self, rank: int, size: int, backend: str, store_path: str):
        self.rank, self.size, self.backend = rank, size, backend
        self.timeout = datetime.timedelta(seconds=TIMEOUT_S)
        store = dist.FileStore(store_path, size)
        store.set_timeout(self.timeout)
        if backend == "gloo":
            opts = dist.ProcessGroupGloo._Options()
            opts._devices = [dist.ProcessGroupGloo.create_device(
                hostname="127.0.0.1")]
            opts._timeout = self.timeout
            self.pg = dist.ProcessGroupGloo(store, rank, size, opts)
        elif backend == "nccl":
            opts = dist.ProcessGroupNCCL.Options()
            opts._timeout = self.timeout
            self.pg = dist.ProcessGroupNCCL(store, rank, size, opts)
        else:
            raise ValueError(f"unknown backend {backend!r}")
        # bytes received by this rank's gathers, by op
        self.recv_bytes: Dict[str, int] = {}

    def all_gather(self, t: torch.Tensor, dim: int, op: str) -> torch.Tensor:
        """Every rank's ``t`` concatenated along ``dim`` in rank order. The
        tensors travel as their raw bytes (a ``uint8`` view), so the
        gather is exact for any dtype and never depends on which dtypes
        the backend takes (gloo refuses int16, for one). gloo takes CUDA
        tensors for ``allgather`` and stages them through host memory
        itself (checked on an H100 with torch 2.11), so the card's
        tensors are passed as they are. Raises if the collective fails or
        times out; there is no local stand-in."""
        t = t.contiguous()
        b = t.view(torch.uint8)
        outs = [torch.empty_like(b) for _ in range(self.size)]
        self.pg.allgather([outs], [b]).wait(self.timeout)
        self.recv_bytes[op] = self.recv_bytes.get(op, 0) \
            + (self.size - 1) * b.numel()
        return torch.cat(outs, dim=dim % t.dim()).view(t.dtype)

    def close(self) -> None:
        self.pg = None


class TPServePlan:
    """What a ``tp``-rank replica needs beyond the single-device engine:
    which dims shard (``sharded_dims``), how to slice a ``state_dict``
    entry and a cache entry for a rank, the gather hooks of the serve
    forward (``shard_fn``) and the per-op collective-byte account."""

    def __init__(self, cfg: ModelConfig, tp: int):
        if tp < 2:
            raise ValueError("TPServePlan is for tp >= 2; the engine runs "
                             "the plain single-device step at tp=1")
        self.cfg = cfg
        self.tp = tp
        # A dim shards only when it divides tp; else that family of
        # parameters and activations replicates and its hook is the
        # identity (24 heads over 5 ranks, 4 kv-heads over 8 must not
        # fail)
        self.heads_ok = (cfg.num_heads % tp == 0
                         and cfg.num_kv_heads % tp == 0)
        self.ffn_ok = cfg.d_ff % tp == 0
        self.moe_ok = cfg.moe is not None and cfg.moe.num_experts % tp == 0
        self.vocab_ok = (not cfg.tie_embeddings
                         and cfg.vocab_padded % tp == 0)
        self.sharded_dims = {
            "heads": self.heads_ok, "ffn": self.ffn_ok,
            "experts": self.moe_ok, "vocab": self.vocab_ok,
        }

    # ----------------------------------------------------------- params
    def param_dim(self, name: str) -> Optional[int]:
        """The dim along which the ``state_dict`` entry ``name`` shards,
        or None (replicated): JAX's ``_param_spec`` on the port's names.
        ``wq`` / ``wk`` / ``wv`` ``[d, H|KV, hd]`` on dim 1; a dense
        ``ffn.w_gate`` / ``ffn.w_up`` ``[d, F]`` on dim 1; the MoE
        ``moe.w_gate`` / ``moe.w_up`` / ``moe.w_down`` ``[E, ...]`` on
        dim 0; ``lm_head [d, Vp]`` on dim 1."""
        path = name.split(".")
        leaf = path[-1]
        parent = path[-2] if len(path) >= 2 else ""
        if leaf in ("wq", "wk", "wv") and self.heads_ok:
            return 1
        if leaf == "lm_head" and self.vocab_ok:
            return 1
        if parent == "moe":
            return 0 if leaf in ("w_gate", "w_up", "w_down") \
                and self.moe_ok else None
        if parent == "ffn" and self.ffn_ok and leaf in ("w_gate", "w_up"):
            return 1
        return None

    def shard_param(self, name: str, t: torch.Tensor,
                    rank: int) -> torch.Tensor:
        """Rank ``rank``'s slice of the entry ``name`` (a copy, so the
        whole tensor can be freed), or ``t`` itself where it
        replicates."""
        dim = self.param_dim(name)
        if dim is None:
            return t
        n = t.shape[dim] // self.tp
        return t.narrow(dim, rank * n, n).contiguous()

    # ----------------------------------------------------------- cache
    def local_cfg(self) -> ModelConfig:
        """The rank-local view of the config that sizes a rank's caches:
        ``num_heads`` and ``num_kv_heads`` divided by ``tp`` where the
        heads shard. The forward reads head counts from its tensors; only
        cache construction reads them from a config."""
        if not self.heads_ok:
            return self.cfg
        return dataclasses.replace(
            self.cfg, num_heads=self.cfg.num_heads // self.tp,
            num_kv_heads=self.cfg.num_kv_heads // self.tp)

    def cache_dims(self, entry: Sequence) -> tuple:
        """The sharded dim of each field of one cache entry (JAX's
        ``cache_specs``): the kv-head axis (2) of every paged, dense and
        int8 page and scale buffer where the heads shard; None for a
        slot cache's ``pos``, for Mamba state and where heads
        replicate."""
        fields = getattr(entry, "_fields", None) or ("k",) * len(entry)
        if not self.heads_ok or fields == ("conv", "ssm"):
            return (None,) * len(entry)
        return tuple(None if f == "pos" else 2 for f in fields)

    def shard_pages(self, pages: Dict[int, tuple], rank: int) -> Dict:
        """A host payload's pages (``{layer: (k, v[, k_scale,
        v_scale])}``, every kv-head) cut to rank ``rank``'s heads."""
        out = {}
        for li, entry in pages.items():
            out[li] = tuple(
                a if d is None else a.narrow(
                    d, rank * (a.shape[d] // self.tp),
                    a.shape[d] // self.tp).contiguous()
                for a, d in zip(entry, self.cache_dims(entry)))
        return out

    def join_pages(self, shards: List[Dict[int, tuple]]) -> Dict:
        """The ranks' page payloads (rank order) joined on the kv-head
        axis: the payload a tp=1 engine holds."""
        out = {}
        for li, entry in shards[0].items():
            dims = self.cache_dims(entry)
            out[li] = tuple(
                entry[i] if d is None
                else torch.cat([s[li][i] for s in shards], dim=d)
                for i, d in enumerate(dims))
        return out

    # ----------------------------------------------------------- hooks
    def shard_fn(self, group: TPGroup) -> Callable:
        """The ``shard(t, kind)`` closure the serve forward threads through
        attention, the FFN, the MoE and the logits on rank
        ``group.rank``: each hook all-gathers the sharded output axis, in
        rank order, so that the combine after it runs replicated."""
        heads_ok, ffn_ok = self.heads_ok, self.ffn_ok
        moe_ok, vocab_ok = self.moe_ok, self.vocab_ok
        e_loc = (self.cfg.moe.num_experts // self.tp) if moe_ok else 0
        rank = group.rank

        def shard(t, kind):
            if kind == "tp_heads" and heads_ok:
                # o [B, S, H_loc, hd] -> [B, S, H, hd] before the wo einsum
                return group.all_gather(t, 2, "heads")
            if kind == "tp_ffn" and ffn_ok:
                # h [..., F_loc] -> [..., F] before the replicated w_down
                return group.all_gather(t, t.dim() - 1, "ffn")
            if kind == "tp_experts" and moe_ok:
                # eo [..., E_loc, D] -> [..., E, D] before the gate combine
                return group.all_gather(t, t.dim() - 2, "experts")
            if kind == "tp_expert_ids" and moe_ok:
                # global expert ids -> this rank's local ids (negative or
                # >= E_loc off this rank; the caller drops those)
                return t - rank * e_loc
            if kind == "logits" and vocab_ok:
                # [N, Vp_loc] -> [N, Vp] before the greedy argmax
                return group.all_gather(t, t.dim() - 1, "logits")
            return t

        return shard

    # ----------------------------------------------------- comm accounting
    def collective_bytes(self, n_tokens: int, n_sample_rows: int,
                         bytes_per_el: int = 4) -> Dict[str, float]:
        """Ring all-gather traffic (full_size * (tp-1) bytes across the
        interconnect) per fused dispatch, by op — feeds the engine's
        ``tp_collective_bytes`` counters and the
        ``repro_tp_collective_bytes_total{op=}`` scrape."""
        cfg, tp = self.cfg, self.tp
        fac = float(tp - 1)
        n_attn = sum(1 for l in cfg.layers if l.mixer != MAMBA)
        out: Dict[str, float] = {}
        if self.heads_ok and n_attn:
            out["heads"] = (n_tokens * n_attn * cfg.num_heads
                            * cfg.head_dim * bytes_per_el * fac)
        n_dense = sum(1 for l in cfg.layers if l.ffn == "dense")
        if self.ffn_ok and n_dense:
            out["ffn"] = (n_tokens * n_dense * cfg.d_ff
                          * bytes_per_el * fac)
        n_moe = sum(1 for l in cfg.layers if l.ffn == "moe")
        if self.moe_ok and n_moe:
            out["experts"] = (n_tokens * n_moe * cfg.moe.num_experts
                              * cfg.d_model * bytes_per_el * fac)
        if self.vocab_ok and n_sample_rows:
            out["logits"] = (n_sample_rows * cfg.vocab_padded
                             * bytes_per_el * fac)
        return out
