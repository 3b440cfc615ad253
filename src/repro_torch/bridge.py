"""Carry weights, optimizer state, paged caches and swap payloads between
the JAX package and the port.

Everything crosses as numpy arrays, so this module imports neither JAX
nor the JAX package: a caller turns JAX arrays into numpy first (for
example ``jax.tree.map(np.asarray, params)``). JAX's bf16 arrays arrive
as numpy arrays of the ``bfloat16`` dtype that ``ml_dtypes`` defines;
they are read through a 16-bit integer view, bit for bit, so the port
needs no ``ml_dtypes`` of its own.
"""
from __future__ import annotations

from typing import Any, Dict, List, Mapping, Sequence

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.engine.optim import AdamWState, named_leaves
from repro_torch.models.mamba2 import MambaState
from repro_torch.models.transformer import (PagedAttnCache,
                                            QuantPagedAttnCache)


def tensor_from_numpy(a) -> torch.Tensor:
    """A numpy array (or anything ``np.asarray`` takes) as a CPU tensor of
    the same dtype and bits; a ``bfloat16`` array, or the 2-byte void
    array that numpy reads back from an ``.npz`` where JAX saved one,
    becomes a ``torch.bfloat16`` tensor through its int16 view."""
    a = np.array(a)
    if a.dtype.name == "bfloat16" or (a.dtype.kind == "V"
                                      and a.dtype.itemsize == 2):
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor as a numpy array on the host; bf16 becomes float32, which
    holds every bf16 value exactly."""
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


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
    the port's ``state_dict``: ``{"layers.3.attn.wq": tensor, ...}``,
    an encoder-decoder model's ``encoder.layers.0.attn.wq``,
    ``encoder.final_norm`` and ``layers.3.cross.wq`` included. Load it
    with ``Transformer.load_state_dict`` or pass it to either engine
    (``params=...``)."""
    flat: Dict[str, np.ndarray] = {}
    _flatten(tree, "", flat)
    return {k: tensor_from_numpy(v) for k, v in flat.items()}


def _nest(flat: Mapping[str, Any]) -> Dict[str, Any]:
    """``{"layers.0.attn.wq": a, ...}`` as the JAX tree: nested dicts,
    with a list where every key of a level is an index."""
    tree: Dict[str, Any] = {}
    for name, a in flat.items():
        node = tree
        *path, leaf = name.split(".")
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = a

    def lists(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [lists(node[str(i)]) for i in range(len(node))]
        return {k: lists(v) for k, v in node.items()}
    return lists(tree)


def params_to_numpy(params) -> Dict[str, Any]:
    """The port's parameters (a ``Transformer`` or its ``state_dict``) as
    the JAX parameter tree of numpy arrays (bf16 as float32), the inverse
    of ``params_from_numpy``: ``{"embed": ..., "layers": [{"attn":
    {"wq": ...}, ...}, ...], ...}``. A JAX caller takes it as it is
    (``jax.tree.map(jnp.asarray, tree)``)."""
    return _nest({n: tensor_to_numpy(t)
                  for n, t in named_leaves(params).items()})


def adamw_to_numpy(state: AdamWState) -> Dict[str, Any]:
    """The port's AdamW state as ``{"step", "mu", "nu"}`` of numpy arrays
    in the JAX layout (``repro.engine.optim.AdamWState(**d)`` builds
    JAX's): ``step`` int32 of shape (), the moments as JAX parameter
    trees."""
    return {"step": tensor_to_numpy(state.step),
            "mu": _nest({n: tensor_to_numpy(t) for n, t in state.mu.items()}),
            "nu": _nest({n: tensor_to_numpy(t) for n, t in state.nu.items()})}


def adamw_from_numpy(state, device="cuda") -> AdamWState:
    """A JAX AdamW state (``AdamWState(step, mu, nu)`` of numpy arrays, or
    a mapping with those keys) as the port's on ``device``: the moments
    fp32, keyed as the port's parameters (``layers.0.attn.wq``). Raises
    without a card unless ``device="cpu"``."""
    dev = resolve_device(device)
    get = state.get if isinstance(state, Mapping) else \
        (lambda k: getattr(state, k))

    def moments(tree):
        flat: Dict[str, np.ndarray] = {}
        _flatten(tree, "", flat)
        return {k: tensor_from_numpy(v).float().to(dev)
                for k, v in flat.items()}
    return AdamWState(
        step=torch.tensor(np.asarray(get("step")), dtype=torch.int32,
                          device=dev),
        mu=moments(get("mu")), nu=moments(get("nu")))


def _cache_type(entry):
    """The port's tuple type for one JAX cache entry, by its fields (or,
    for a plain tuple, its length: 4 fields are int8 pages and scales)."""
    fields = getattr(entry, "_fields", None)
    if fields == MambaState._fields:
        return MambaState
    if fields == QuantPagedAttnCache._fields or len(entry) == 4:
        return QuantPagedAttnCache
    return PagedAttnCache


def paged_cache_from_numpy(cache, device="cuda") -> Dict[str, List]:
    """A JAX paged cache (``{"layers": [...]}`` of numpy arrays: ``(k,
    v)`` pages ``[num_blocks, bs, KV, hd]`` or int8 ``(k, v, k_scale,
    v_scale)`` with bf16 scales ``[num_blocks, bs, KV]`` for attention
    layers, ``MambaState(conv, ssm)`` rows ``[n_slots, ...]`` for Mamba
    layers) as the port's on ``device``, dtypes kept, with the sink page
    appended to every attention layer and the sink row to every Mamba
    layer. Raises without a card unless ``device="cpu"``."""
    dev = resolve_device(device)
    layers = []
    for entry in cache["layers"]:
        ts = [tensor_from_numpy(t).to(dev) for t in entry]
        layers.append(_cache_type(entry)(
            *(torch.cat([t, torch.zeros_like(t[:1])]) for t in ts)))
    return {"layers": layers}


def paged_cache_to_numpy(cache) -> Dict[str, Sequence]:
    """The port's paged cache as numpy arrays, without the sink page or
    sink row: ``{"layers": [(k, v), (k, v, k_scale, v_scale) or (conv,
    ssm), ...]}``, the layout of the JAX cache. int8 pages stay int8;
    every float (bf16 scales and pages included) becomes float32, which
    holds a bf16 value exactly."""
    def host(t):
        t = t[:-1].detach().cpu()
        return (t if t.dtype == torch.int8 else t.float()).numpy()
    return {"layers": [tuple(host(t) for t in c) for c in cache["layers"]]}


def swap_payload_from_numpy(payload: Mapping) -> Dict[str, Any]:
    """A JAX engine's wire payload (``JaxEngine.export_swapped``: the
    swap-store entry with its host pages per attention layer and recurrent
    state per Mamba layer, the prompt tokens and the generated stream) as
    ``TorchEngine.import_swapped`` takes it: the same structure with every
    page and state row a CPU tensor of its own dtype (int8 pages and bf16
    scales kept)."""
    swap = payload["swap"]
    return {
        "swap": {
            "tokens": int(swap["tokens"]),
            "last_token": int(swap["last_token"]),
            "pages": {int(li): tuple(tensor_from_numpy(a) for a in saved)
                      for li, saved in swap["pages"].items()},
            "mamba": {int(li): tuple(tensor_from_numpy(a) for a in saved)
                      for li, saved in swap["mamba"].items()}},
        "prompt": np.asarray(payload["prompt"], np.int32),
        "generated": [int(t) for t in payload["generated"]]}
