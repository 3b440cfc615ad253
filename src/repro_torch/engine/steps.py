"""The training step and the offline prefill and decode steps, as the
JAX package's ``engine/steps.py``:

  make_train_step(cfg)   -> train_step(params, opt, batch) -> (params, opt, metrics)
  make_prefill_step(cfg) -> prefill_step(params, cache, batch) -> (logits_last, cache)
  make_serve_step(cfg)   -> serve_step(params, cache, token) -> (next_token_logits, cache)

PyTorch runs eagerly, so these are plain closures where JAX returns
functions to jit. JAX's ``make_fused_serve_step`` has its counterpart in
``engine/torch_backend.py::TorchEngine``, which runs one
``fused_serve_forward`` per BatchPlan. The sharding hooks (``shard=``,
``grad_shardings=``) wait for the tensor-parallel slice.

The train step turns ``requires_grad`` on for the parameters it trains
(``init_train_state`` makes them so), takes their gradients with
``torch.autograd.grad`` and updates them in place (``engine/optim.py``).
Nothing here runs under ``inference_mode``; the prefill and decode steps
call the offline functions, which do.
"""
from __future__ import annotations

from typing import Callable, Dict

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import (Transformer, decode_step,
                                            forward_train, init_params,
                                            prefill)

from .optim import AdamWState, adamw_update, init_adamw, named_leaves


def cross_entropy(logits, labels, vocab_size: int):
    """Mean cross-entropy over the labels >= 0. The padded vocabulary's
    logits are masked to -1e30 before the logsumexp; the gold logit is a
    gather, which picks the same value as JAX's iota compare and sum
    without a ``[B, S, V]`` mask."""
    vp = logits.shape[-1]
    logits = logits.float()
    if vp > vocab_size:
        pad = torch.arange(vp, device=logits.device) >= vocab_size
        logits = torch.where(pad, -1e30, logits)
    lse = torch.logsumexp(logits, dim=-1)
    mask = labels >= 0
    safe = torch.where(mask, labels, 0).long()
    gold = torch.gather(logits, -1, safe[..., None])[..., 0]
    nll = (lse - gold) * mask
    return nll.sum() / torch.clamp_min(mask.sum(), 1)


def _trainable(params: Transformer) -> Dict[str, torch.Tensor]:
    """The parameters by name, ``requires_grad`` turned on."""
    leaves = named_leaves(params)
    for p in leaves.values():
        p.requires_grad_(True)
    return leaves


def make_train_step(cfg: ModelConfig, lr: float = 3e-4,
                    aux_weight: float = 0.01, remat: bool = True,
                    microbatches: int = 1) -> Callable:
    """``train_step(params, opt, batch) -> (params, opt, metrics)``: the
    loss (cross-entropy, plus ``aux_weight`` times the MoE load-balance
    loss where the model has one), its gradients and one AdamW update in
    place. metrics: ``loss``, ``grad_norm`` and the MoE metrics (0-d
    tensors). ``microbatches > 1`` accumulates the gradients in fp32
    over that many equal slices of the batch, in order, before the one
    update, then divides them by the count; the loss is the slices' mean
    and no MoE metric is reported, as in JAX."""

    def loss_fn(params, batch):
        logits, aux = forward_train(params, cfg, batch, remat=remat)
        loss = cross_entropy(logits, batch["labels"], cfg.vocab_size)
        if "moe_aux_loss" in aux:
            loss = loss + aux_weight * aux["moe_aux_loss"]
        return loss, aux

    def train_step(params: Transformer, opt: AdamWState, batch: Dict):
        leaves = _trainable(params)
        names = list(leaves)
        if microbatches <= 1:
            loss, aux = loss_fn(params, batch)
            grads = dict(zip(names, torch.autograd.grad(
                loss, list(leaves.values()))))
            loss = loss.detach()
            aux = {k: v.detach() for k, v in aux.items()}
        else:
            mb = microbatches
            gsum = {n: torch.zeros(p.shape, dtype=torch.float32,
                                   device=p.device)
                    for n, p in leaves.items()}
            lsum = torch.zeros((), dtype=torch.float32,
                               device=next(iter(leaves.values())).device)
            for i in range(mb):
                mbatch = {k: v.reshape(mb, v.shape[0] // mb,
                                       *v.shape[1:])[i]
                          for k, v in batch.items()}
                l, _ = loss_fn(params, mbatch)
                g = torch.autograd.grad(l, list(leaves.values()))
                for n, gi in zip(names, g):
                    gsum[n].add_(gi.float())
                lsum = lsum + l.detach()
            grads = {n: g / mb for n, g in gsum.items()}
            loss, aux = lsum / mb, {}
        params, opt, gnorm = adamw_update(params, grads, opt, lr=lr)
        return params, opt, {"loss": loss, "grad_norm": gnorm, **aux}

    return train_step


def make_prefill_step(cfg: ModelConfig, fresh: bool = True) -> Callable:
    """Full-prompt prefill from the cache's lengths: ``prefill_step(params,
    cache, batch) -> (logits of the last position [B, 1, Vp], cache)``,
    the cache updated in place. ``fresh``: attention over the locally
    computed K/V, the cache only written (start from an empty cache)."""
    def prefill_step(params, cache, batch):
        tokens = batch["tokens"]
        extras = {k: v for k, v in batch.items() if k != "tokens"}
        logits, cache = prefill(params, cfg, cache, tokens,
                                start_pos=cache["len"][:tokens.shape[0]]
                                .clone(), batch_extras=extras, fresh=fresh)
        return logits[:, -1:], cache

    return prefill_step


def make_serve_step(cfg: ModelConfig) -> Callable:
    """One decode token against the cache: ``serve_step(params, cache,
    token [B, 1]) -> (logits [B, 1, Vp], cache)``."""
    def serve_step(params, cache, token):
        return decode_step(params, cfg, cache, token)

    return serve_step


def sample_greedy(logits, vocab_size: int):
    """Greedy sampling restricted to the real (unpadded) vocab."""
    return torch.argmax(logits[..., :vocab_size], dim=-1).to(torch.int32)


def init_train_state(cfg: ModelConfig, generator: torch.Generator,
                     device="cuda", dtype=torch.float32):
    """Random parameters (``init_params``), ``requires_grad`` on, and a
    fresh AdamW state. Raises without a card unless ``device="cpu"``."""
    params = init_params(cfg, generator, device, dtype)
    _trainable(params)
    return params, init_adamw(params)
