"""AdamW on the port's parameters, as the JAX package's ``engine/optim.py``.

Parameters may be fp32 or bf16; the first and second moments are always
fp32, and each update is computed in fp32 and cast to its parameter's
dtype. Defaults as in JAX: b1 0.9, b2 0.95, eps 1e-8, weight decay 0.1,
and a global-norm clip at 1.0 over every gradient.

One departure, for memory: the update is made in place, one tensor at a
time, into the parameters and the moments (JAX returns new trees, as it
returns new caches). A full-width llama3.2-3b in fp32 holds 3.61 B
parameters, and its parameters, gradients and moments together take
57.7 GB; a functional update would need another copy of the largest
three. ``adamw_update`` still returns ``(params, state, grad_norm)`` as
JAX's does, the same objects updated.

``params`` is a ``Transformer`` (or any ``nn.Module``), whose
``named_parameters()`` name the leaves (``layers.3.attn.wq``), or a dict
of tensors; the moments are dicts under the same names. The parameters
and gradients may be DTensors (a sharded train step): each moment then
takes its parameter's placements (``zeros_like``), and every op of the
update, the global norm's sums included, has a DTensor strategy.
"""
from __future__ import annotations

from typing import Dict, Mapping, NamedTuple, Union

import torch
from torch import nn

Params = Union[nn.Module, Mapping[str, torch.Tensor]]


class AdamWState(NamedTuple):
    step: torch.Tensor                 # [] int32, updates made
    mu: Dict[str, torch.Tensor]        # first moments, fp32
    nu: Dict[str, torch.Tensor]        # second moments, fp32


def named_leaves(params: Params) -> Dict[str, torch.Tensor]:
    """``params`` as a dict of its tensors by name, in the order of the
    JAX tree's leaves (``jax.tree.leaves``: dict keys sorted, list items
    by index), so that sums over the leaves run in JAX's order."""
    named = dict(params.named_parameters()) \
        if isinstance(params, nn.Module) else dict(params)

    def key(name):
        return tuple((0, int(k), "") if k.isdigit() else (1, 0, k)
                     for k in name.split("."))
    return {n: named[n] for n in sorted(named, key=key)}


def init_adamw(params: Params) -> AdamWState:
    leaves = named_leaves(params)
    dev = next(iter(leaves.values())).device

    def zeros():
        return {n: torch.zeros_like(p, dtype=torch.float32)
                for n, p in leaves.items()}
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      mu=zeros(), nu=zeros())


@torch.no_grad()
def adamw_update(params: Params, grads: Mapping[str, torch.Tensor],
                 state: AdamWState, *, lr: float = 3e-4, b1: float = 0.9,
                 b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1, grad_clip: float = 1.0):
    """One AdamW step, in place: ``grads`` by the parameters' names.
    The bias corrections ``1 - b ** step`` are formed in fp32, as JAX
    forms them from its weakly typed constants; so are the clip scale and
    every update. Returns ``(params, state, grad_norm)``, the norm before
    the clip."""
    leaves = named_leaves(params)
    gnorm = None
    for n in leaves:        # JAX's order of the leaves, one sum at a time
        sq = torch.sum(torch.square(grads[n].float()))
        gnorm = sq if gnorm is None else gnorm + sq
    gnorm = torch.sqrt(gnorm)
    scale = torch.clamp(grad_clip / torch.clamp_min(gnorm, 1e-9), max=1.0)
    step = state.step + 1
    stepf = step.float()
    bc1 = 1 - torch.tensor(b1, dtype=torch.float32, device=stepf.device) \
        ** stepf
    bc2 = 1 - torch.tensor(b2, dtype=torch.float32, device=stepf.device) \
        ** stepf
    for n, p in leaves.items():
        m, v = state.mu[n], state.nu[n]
        g = grads[n].float() * scale
        m.mul_(b1).add_(g * (1 - b1))
        v.mul_(b2).add_(g * (1 - b2) * g)
        u = (m / bc1) / (torch.sqrt(v / bc2) + eps)
        u = u + weight_decay * p.float()
        p.copy_((p.float() - lr * u).to(p.dtype))
    return params, AdamWState(step, state.mu, state.nu), gnorm
