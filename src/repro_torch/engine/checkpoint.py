"""Checkpoints: flat-key ``.npz`` save and restore of the parameters and
the optimizer state, as the JAX package's ``engine/checkpoint.py``.

The file's keys are the JAX file's own, so a checkpoint crosses between
the two packages both ways: ``__step__``; ``p/<path>`` for each
parameter, its path the JAX tree's (``p/embed``,
``p/layers/0/attn/wq``: the port's ``layers.0.attn.wq`` with ``/`` for
``.``); ``o/step``, ``o/mu/<path>`` and ``o/nu/<path>`` for the AdamW
state. Restore checks every shape against the template's, as JAX does,
and casts each array to the template tensor's dtype.

bf16 leaves are written as float32, which holds every bf16 value
exactly (numpy has no bf16 without ``ml_dtypes``, which the port does not
use); restoring into a bf16 template casts them back, bit for bit. A
file that JAX wrote with bf16 leaves stores them as 2-byte void arrays,
which restore reads as bf16 bits.
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.bridge import tensor_from_numpy, tensor_to_numpy

from .optim import AdamWState, Params, named_leaves


def _flatten(params: Params) -> Dict[str, torch.Tensor]:
    return {n.replace(".", "/"): t for n, t in named_leaves(params).items()}


def _flatten_opt(opt: AdamWState) -> Dict[str, torch.Tensor]:
    out = {"step": opt.step}
    for part in ("mu", "nu"):
        for n, t in getattr(opt, part).items():
            out[f"{part}/{n.replace('.', '/')}"] = t
    return out


def save_checkpoint(path, params: Params,
                    opt_state: Optional[AdamWState] = None,
                    step: int = 0) -> None:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    blobs = {"__step__": np.asarray(step)}
    for k, t in _flatten(params).items():
        blobs[f"p/{k}"] = tensor_to_numpy(t)
    if opt_state is not None:
        for k, t in _flatten_opt(opt_state).items():
            blobs[f"o/{k}"] = tensor_to_numpy(t)
    np.savez(path, **blobs)


@torch.no_grad()
def _restore(z, template: Dict[str, torch.Tensor], prefix: str) -> None:
    for k, t in template.items():
        arr = z[f"{prefix}/{k}"]
        if tuple(arr.shape) != tuple(t.shape):
            raise ValueError(f"checkpoint {prefix}/{k}: shape "
                             f"{tuple(arr.shape)}, the template's "
                             f"{tuple(t.shape)}")
        t.copy_(tensor_from_numpy(arr).to(t.dtype))


def restore_checkpoint(path, params_template: Params,
                       opt_template: Optional[AdamWState] = None
                       ) -> Tuple[Params, Optional[AdamWState], int]:
    """Read ``path`` into the templates' tensors, in place (their devices
    and dtypes kept), and return ``(params, opt, step)``. Raises on a
    missing key or a shape that differs from the template's."""
    with np.load(Path(path), allow_pickle=False) as z:
        step = int(z["__step__"])
        _restore(z, _flatten(params_template), "p")
        if opt_template is not None:
            _restore(z, _flatten_opt(opt_template), "o")
    return params_template, opt_template, step
