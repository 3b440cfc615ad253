"""Carry weights and paged caches between the JAX package and the port.

Everything crosses as numpy arrays, so this module imports neither JAX
nor the JAX package: a caller turns JAX arrays into numpy first (for
example ``jax.tree.map(np.asarray, params)``).
"""
from __future__ import annotations

from typing import Any, Dict, List, Mapping, Sequence

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.transformer import PagedAttnCache


def _flatten(tree: Any, prefix: str, out: Dict[str, np.ndarray]) -> None:
    if isinstance(tree, Mapping):
        for k, v in tree.items():
            _flatten(v, f"{prefix}{k}.", out)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _flatten(v, f"{prefix}{i}.", out)
    else:
        out[prefix[:-1]] = np.asarray(tree)


def params_from_numpy(tree) -> Dict[str, torch.Tensor]:
    """The JAX parameter tree (nested dicts and lists of numpy arrays) as
    the port's ``state_dict``: ``{"layers.3.attn.wq": tensor, ...}``.
    Load it with ``Transformer.load_state_dict`` or pass it to
    ``TorchEngine(params=...)``."""
    flat: Dict[str, np.ndarray] = {}
    _flatten(tree, "", flat)
    return {k: torch.from_numpy(np.array(v)) for k, v in flat.items()}


def paged_cache_from_numpy(cache, device="cuda") -> Dict[str, List]:
    """A JAX paged cache (``{"layers": [(k, v), ...]}`` with numpy pages
    ``[num_blocks, bs, KV, hd]``) as the port's on ``device``, with the
    sink page appended to every layer. Raises without a card unless
    ``device="cpu"``."""
    dev = resolve_device(device)
    layers = []
    for k, v in cache["layers"]:
        kt, vt = (torch.from_numpy(np.array(a)).to(dev) for a in (k, v))
        layers.append(PagedAttnCache(
            torch.cat([kt, torch.zeros_like(kt[:1])]),
            torch.cat([vt, torch.zeros_like(vt[:1])])))
    return {"layers": layers}


def paged_cache_to_numpy(cache) -> Dict[str, Sequence]:
    """The port's paged cache as numpy pages, without the sink page: the
    layout of the JAX ``PagedAttnCache`` (``{"layers": [(k, v), ...]}``).
    """
    return {"layers": [(c.k[:-1].detach().cpu().float().numpy(),
                        c.v[:-1].detach().cpu().float().numpy())
                       for c in cache["layers"]]}
