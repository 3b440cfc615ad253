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
from repro_torch.models.mamba2 import MambaState
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
    """A JAX paged cache (``{"layers": [...]}`` of numpy arrays: ``(k,
    v)`` pages ``[num_blocks, bs, KV, hd]`` for attention layers,
    ``MambaState(conv, ssm)`` rows ``[n_slots, ...]`` for Mamba layers)
    as the port's on ``device``, with the sink page appended to every
    attention layer and the sink row to every Mamba layer. Raises
    without a card unless ``device="cpu"``."""
    dev = resolve_device(device)
    layers = []
    for entry in cache["layers"]:
        cls = MambaState if getattr(entry, "_fields", ()) \
            == MambaState._fields else PagedAttnCache
        a, b = (torch.from_numpy(np.array(t)).to(dev) for t in entry)
        layers.append(cls(torch.cat([a, torch.zeros_like(a[:1])]),
                          torch.cat([b, torch.zeros_like(b[:1])])))
    return {"layers": layers}


def paged_cache_to_numpy(cache) -> Dict[str, Sequence]:
    """The port's paged cache as numpy arrays in float32, without the
    sink page or sink row: ``{"layers": [(k, v) or (conv, ssm), ...]}``,
    the layout of the JAX cache."""
    return {"layers": [tuple(t[:-1].detach().cpu().float().numpy()
                             for t in c) for c in cache["layers"]]}
