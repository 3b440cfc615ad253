"""The mixture-of-experts FFN, in PyTorch.

Counterpart of the JAX package's ``models/moe.py``: ``GROUP_TOKENS``,
``_num_groups`` and ``moe_forward`` (the training path's capacity
dispatch), ``_capacity_ladder``, ``moe_forward_grouped`` (the fused
engine's default) and ``moe_forward_dropless`` keep their names,
the parameter layout of ``init_moe_params`` (``router [d, E]``,
``w_gate`` / ``w_up [E, d, f_e]``, ``w_down [E, f_e, d]``) and their
ops: the router product in x's dtype, an fp32 softmax, top-k, the
normalisation clamped at 1e-9; the serve paths' dense ``[B, S, E]``
gates and ``bse,bsed->bsd`` combine. The serve paths return the output
alone (JAX also returns an empty metrics dict); ``moe_forward`` returns
the output and its load-balance metrics, as JAX's does.

The router, the expert products and the combine each run inside a
program span (``repro_torch.obs.spans``: ``moe.router``, ``moe.experts``,
``moe.combine``), so that a profile reads their device time by name. The
grouped path's one blocking read of its largest segment runs inside
``engine.host_read`` (not a ``moe.`` name: the read's own kernels are
not the FFN's work).

Top-k keeps ``jax.lax.top_k``'s order on ties (the lower expert index
first): router logits computed in bf16 can tie exactly, and
``torch.topk`` on the card promises no order, so the top k are the head
of a stable descending sort.

On a tensor-parallel rank (``distributed/tp_serve.py``) the expert
weights hold the rank's ``E_loc`` experts and the router is replicated:
both serve paths run the rank's experts only and gather the ``[..., E_loc,
d]`` expert outputs of every rank (``constrain(eo, "tp_experts")``)
before the replicated combine, as JAX's branches do.
"""
from __future__ import annotations

from collections import Counter

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.distributed.torch_api import (Partial, Replicate, Shard,
                                               einsum, is_dtensor, local_map)
from repro_torch.obs.spans import span

from .config import ModelConfig

# the capacity rungs that ``moe_forward_grouped`` took in this process,
# rows an expert -> calls. Each call reads its largest segment on the
# host once to pick its rung, so the counts add up to the host reads.
rungs: Counter = Counter()


class MoE(nn.Module):
    """The FFN's parameters, named and shaped as the leaves of the JAX
    ``init_moe_params`` tree. ``transformer.init_params`` draws them at
    that function's scales: router, w_gate and w_up at ``d ** -0.5``,
    w_down at ``d_ff_expert ** -0.5``."""

    def __init__(self, cfg: ModelConfig, device, dtype):
        super().__init__()
        m = cfg.moe
        d, f, e = cfg.d_model, m.d_ff_expert, m.num_experts

        def param(*shape):
            return nn.Parameter(torch.empty(shape, device=device,
                                            dtype=dtype),
                                requires_grad=False)
        self.router = param(d, e)
        self.w_gate = param(e, d, f)
        self.w_up = param(e, d, f)
        self.w_down = param(e, f, d)


GROUP_TOKENS = 4096   # dispatch group size (MaxText-style)


def _num_groups(T: int) -> int:
    """Largest group count with T/G <= GROUP_TOKENS and G | T."""
    if T <= GROUP_TOKENS:
        return 1
    g = -(-T // GROUP_TOKENS)
    while T % g:
        g += 1
    return g


def _no_constrain(t, kind):
    return t


def moe_forward(p: MoE, x, cfg: ModelConfig, constrain=_no_constrain):
    """The training path's capacity dispatch. x: ``[B, S, d]`` ->
    (``[B, S, d]``, metrics).

    Tokens dispatch within groups of up to ``GROUP_TOKENS`` (``G`` of
    ``Tg`` tokens), each expert taking at most ``C = max(K, int(cf * Tg *
    K / E))`` of a group's (token, k) replicas in order: a replica's
    position is the group's one-hot cumsum at its expert, and a replica
    past ``C`` goes to column ``C`` of the ``[G, E, C + 1, d]`` buffer,
    which is cut away (dropped). The experts run as batched products over
    ``[G, E, C, d]``; each replica gathers its row back (zeros where
    dropped) and the top-k rows combine in fp32 with the normalised gates.
    Metrics: ``moe_aux_loss = E * sum(me * ce)`` (the Switch load-balance
    loss: mean router probability times mean routed share, per expert)
    and ``moe_drop_frac``, the share of replicas dropped.

    ``constrain(tensor, kind)`` (the training step's ``shard``) sees the
    grouped input (``"moe_group"``, ``[G, Tg, d]``), both expert buffers
    (``"expert_buffer"``, ``[G, E, C, d]``) and the output
    (``"tokens"``), at JAX's points, and the gathered replicas of a
    sharded step (``"moe_group"``; ``_ExpertShards``)."""
    m = cfg.moe
    B, S, D = x.shape
    T = B * S
    E, K = m.num_experts, m.top_k
    G = _num_groups(T)
    Tg = T // G
    C = max(K, int(m.capacity_factor * Tg * K / E))

    xg = constrain(x.reshape(G, Tg, D), "moe_group")
    with span("moe.router"):
        logits = einsum("gtd,de->gte", xg, p.router).float()
        probs = torch.softmax(logits, dim=-1)
        gate_vals, expert_idx = _top_k(probs, K)                # [G, Tg, K]
        gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(
            1e-9)

    # each (token, k) replica's position within its expert, per group
    ef = expert_idx.reshape(G, Tg * K)                          # [G, TgK]
    oh = F.one_hot(ef, E)                                       # [G, TgK, E]
    pos = torch.gather(torch.cumsum(oh, dim=1) - 1, 2, ef[..., None])[..., 0]
    keep = pos < C
    pos = torch.where(keep, pos, C)                             # C: dropped

    gi = torch.arange(G, device=x.device)[:, None].expand(G, Tg * K)
    xk = xg.repeat_interleave(K, dim=1)                         # [G, TgK, D]
    if is_dtensor(xk):
        buf = _ExpertShards(xk, p.w_gate, E).dispatch(xk, ef, pos, C)
    else:
        buf = torch.zeros((G, E, C + 1, D), dtype=x.dtype, device=x.device)
        buf = buf.index_put((gi, ef, pos), xk, accumulate=True)[:, :, :C]
    buf = constrain(buf, "expert_buffer")

    with span("moe.experts"):
        h = F.silu(einsum("gecd,edf->gecf", buf, p.w_gate)) \
            * einsum("gecd,edf->gecf", buf, p.w_up)
        out_buf = einsum("gecf,efd->gecd", h, p.w_down)
        out_buf = F.pad(out_buf, (0, 0, 0, 1))                  # column C
        out_buf = constrain(out_buf, "expert_buffer")

    with span("moe.combine"):
        if is_dtensor(out_buf):
            gathered = constrain(_ExpertShards(xk, p.w_gate, E).gather(
                out_buf, ef, pos), "moe_group")
        else:
            gathered = out_buf[gi, ef, pos]                     # [G, TgK, D]
        gathered = torch.where(keep[..., None], gathered, 0)
        combined = (gathered.reshape(G, Tg, K, D).float()
                    * gate_vals[..., None]).sum(dim=2)
        out = constrain(combined.reshape(B, S, D).to(x.dtype), "tokens")

    me = probs.mean(dim=(0, 1))                                 # [E]
    ce = oh.float().mean(dim=(0, 1))                            # [E]
    aux = {"moe_aux_loss": E * torch.sum(me * ce),
           "moe_drop_frac": 1.0 - keep.float().mean()}
    return out, aux


class _ExpertShards:
    """The training dispatch's scatter and gather on DTensors, each rank
    on its own shards (``local_map``): its groups (the mesh axes that
    split the groups) and its experts (the axes that split the expert
    weights' dim 0 and not the groups). A rank writes only the replicas
    routed to its experts into its ``[G_l, E_l, C, d]`` buffer (the
    others into a sink row it cuts away), and gathers only those back,
    zeros elsewhere: the gathered rows are each rank's share of every
    row (``Partial`` over the expert axes), reduced by the caller. Every
    cell takes one replica, so the values are the unsharded dispatch's.
    DTensor has no sharding of the scatter over group and expert dims:
    it would gather the whole ``[G, E, C + 1, d]`` buffer on every
    rank."""

    def __init__(self, xk, w, E: int):
        self.mesh = mesh = w.device_mesh
        split = [i for i, pl in enumerate(xk.placements)
                 if isinstance(pl, Shard) and pl.dim == 0]
        experts = [i for i, pl in enumerate(w.placements)
                   if isinstance(pl, Shard) and pl.dim == 0
                   and i not in split]
        rank = 0
        for i in experts:
            rank = rank * mesh.size(i) + mesh.get_local_rank(i)
        n = 1
        for i in experts:
            n *= mesh.size(i)
        self.E_l = E // n
        self.e0 = rank * self.E_l

        def pl(dims, other=Replicate()):
            return tuple(Shard(0) if i in split else
                         dims if i in experts else other
                         for i in range(mesh.ndim))
        self.rows = pl(Replicate())          # [G, TgK, ...]: groups split
        self.rows_partial = pl(Partial())
        self.buf = pl(Shard(1))              # [G, E, C, d]

    def _local(self, ef):
        el = ef - self.e0
        on = (el >= 0) & (el < self.E_l)
        return torch.where(on, el, self.E_l), on

    def dispatch(self, xk, ef, pos, C: int):
        def local(xk, ef, pos):
            G_l, TgK, D = xk.shape
            el, _ = self._local(ef)
            gi = torch.arange(G_l, device=xk.device)[:, None].expand(G_l,
                                                                     TgK)
            buf = torch.zeros((G_l, self.E_l + 1, C + 1, D),
                              dtype=xk.dtype, device=xk.device)
            buf = buf.index_put((gi, el, pos), xk, accumulate=True)
            return buf[:, :self.E_l, :C]
        return local_map(local, out_placements=list(self.buf),
                         in_placements=(self.rows,) * 3,
                         in_grad_placements=(self.rows_partial, self.rows,
                                             self.rows),
                         device_mesh=self.mesh,
                         redistribute_inputs=True)(xk, ef, pos)

    def gather(self, out_buf, ef, pos):
        def local(ob, ef, pos):
            G_l, TgK = ef.shape
            el, on = self._local(ef)
            gi = torch.arange(G_l, device=ob.device)[:, None].expand(G_l,
                                                                     TgK)
            rows = ob[gi, torch.where(on, el, 0), pos]
            return torch.where(on[..., None], rows, 0)
        return local_map(local, out_placements=list(self.rows_partial),
                         in_placements=(self.buf, self.rows, self.rows),
                         device_mesh=self.mesh,
                         redistribute_inputs=True)(out_buf, ef, pos)


def _capacity_ladder(TK: int, E: int):
    """Pow-2 segment capacities from ceil(TK/E) (perfect balance) up to TK
    (total skew). One jitted branch per rung; the runtime picks the first
    rung covering the realized max segment length."""
    lo = -(-TK // E)
    caps, c = [], 1
    while c < lo:
        c *= 2
    while c < TK:
        caps.append(c)
        c *= 2
    caps.append(TK)
    return caps


def _top_k(probs, k: int):
    """The ``k`` largest of the last axis and their indices, largest
    first, ties to the lower index (``jax.lax.top_k``'s order)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route(p: MoE, x, cfg: ModelConfig):
    """The router, as both JAX serve paths run it: the dense normalised
    top-k gates ``[B, S, E]`` (fp32, exact zeros off the top k) and the
    chosen experts ``[B, S, K]``."""
    m = cfg.moe
    with span("moe.router"):
        logits = torch.einsum("bsd,de->bse", x, p.router).float()
        probs = torch.softmax(logits, dim=-1)
        gate_vals, expert_idx = _top_k(probs, m.top_k)
        gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(
            1e-9)
        gates = torch.sum(F.one_hot(expert_idx, m.num_experts).float()
                          * gate_vals[..., None], dim=2)
    return gates, expert_idx


def _experts(p: MoE, buf):
    """Every expert's swiglu over its segment: ``[E, C, d] -> [E, C, d]``,
    three batched products."""
    with span("moe.experts"):
        h = F.silu(torch.bmm(buf, p.w_gate)) * torch.bmm(buf, p.w_up)
        return torch.bmm(h, p.w_down)


def _combine(gates, eo):
    """``bse,bsed->bsd``: each token's expert outputs weighted by its
    gates (exact zeros off the top k)."""
    with span("moe.combine"):
        return torch.einsum("bse,bsed->bsd", gates.to(eo.dtype), eo)


def moe_forward_grouped(p: MoE, x, cfg: ModelConfig,
                        constrain=_no_constrain):
    """Gather-based grouped GEMM for dropless serving. x: ``[B, S, d]``.

    Token replicas sort into per-expert segments (a one-hot cumsum gives
    each replica its position inside its expert), scatter into an
    ``[E, C, d]`` buffer, run as three batched products over C rows, and
    gather back into the dense ``[T, E, d]`` operand that the dropless
    combine consumes: the entries off the top k stay exact zeros against
    exact-zero gates, which is what makes this path compute what
    ``moe_forward_dropless`` computes.

    C is the first rung of the pow-2 ``_capacity_ladder`` that covers the
    realised largest segment. JAX picks the rung on the device with
    ``lax.switch``; eager torch needs the buffer's shape on the host, so
    this reads the largest segment once per call (``rungs`` counts the
    calls by rung). The ladder keeps the shapes to a few static rungs.

    Expert-sharded (``p`` holds ``E_loc < E`` experts: a tensor-parallel
    rank, JAX's ``_make_local``): the routing, the positions and the
    rung are the global ones, from the replicated router, so every rank
    reads the same largest segment and takes the same rung. The rank's
    replicas get local ids through ``constrain(ids, "tp_expert_ids")``;
    those of other ranks go to the explicit index ``E_loc``, a sink row
    of the buffer and of the output that is cut away (JAX's scatter
    drops it). The ``[T, E_loc, d]`` outputs gather through
    ``constrain(eo, "tp_experts")`` into the ``[T, E, d]`` operand,
    exact slices of the single-device one."""
    m = cfg.moe
    B, S, D = x.shape
    E, K = m.num_experts, m.top_k
    T = B * S
    TK = T * K
    gates, expert_idx = _route(p, x, cfg)
    xf = x.reshape(T, D)
    ef = expert_idx.reshape(TK)
    tok = torch.div(torch.arange(TK, device=x.device), K,
                    rounding_mode="floor")
    # expert-major [E, TK], so that the cumsum runs along the contiguous
    # axis: torch's scan across the outer axis is the slow one on the card
    # (PERF.md section 6)
    oh = F.one_hot(ef, E).t().contiguous()
    pos = torch.gather(torch.cumsum(oh, dim=1) - 1, 0,
                       ef[None, :])[0]                       # [TK]
    with span("engine.host_read"):
        mx = int(oh.sum(dim=1).max())
    caps = _capacity_ladder(TK, E)
    C = caps[sum(c < mx for c in caps[:-1])]
    rungs[C] += 1
    E_loc = p.w_gate.shape[0]
    local = E_loc != E          # expert-sharded: a tensor-parallel rank
    if local:
        el = constrain(ef, "tp_expert_ids")
        ef = torch.where((el >= 0) & (el < E_loc), el, E_loc)
    # expert-sharded, row E_loc is the sink of other ranks' replicas
    n_rows = E_loc + 1 if local else E
    buf = torch.zeros((n_rows, C, D), dtype=x.dtype, device=x.device)
    buf[ef, pos] = xf[tok]
    out = _experts(p, buf[:E_loc] if local else buf)
    rows = out[ef.clamp(max=E_loc - 1) if local else ef, pos]   # [TK, d]
    # (tok, ef) pairs are unique: top-k picks distinct experts
    eo = torch.zeros((T, n_rows, D), dtype=x.dtype, device=x.device)
    eo[tok, ef] = rows
    if local:
        eo = constrain(eo[:, :E_loc].reshape(B, S, E_loc, D), "tp_experts")
    return _combine(gates, eo.reshape(B, S, E, D)).to(x.dtype)


def _expert_sweep(p: MoE, x):
    """Every expert over every token: ``[B, S, d] -> [B, S, E, d]``."""
    with span("moe.experts"):
        h = F.silu(torch.einsum("bsd,edf->bsef", x, p.w_gate)) \
            * torch.einsum("bsd,edf->bsef", x, p.w_up)
        return torch.einsum("bsef,efd->bsed", h, p.w_down)


def moe_forward_dropless(p: MoE, x, cfg: ModelConfig,
                         constrain=_no_constrain):
    """Per-token top-k MoE without capacity dropping: every expert runs
    over every token and the gates zero the experts off the top k, so a
    token's output is a function of that token alone. x: ``[B, S, d]``.
    It costs E / top_k times the expert products of the grouped path.
    Expert-sharded (``p`` holds fewer than E experts), the rank's
    ``[B, S, E_loc, d]`` outputs gather through ``constrain(eo,
    "tp_experts")`` before the combine."""
    gates, _ = _route(p, x, cfg)
    eo = _expert_sweep(p, x)
    if p.w_gate.shape[0] != cfg.moe.num_experts:
        eo = constrain(eo, "tp_experts")
    return _combine(gates, eo).to(x.dtype)
