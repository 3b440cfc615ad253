"""Shape-only stand-ins for every input of the steps, the counterpart of
the JAX package's ``launch/specs.py``: tensors on the meta device, which
hold no data. The dry-run places them by ``ShardingRules``."""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.configs.shapes import InputShape
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import init_cache


def batch_shapes(cfg: ModelConfig, shape: InputShape) -> Dict[str, Tuple]:
    """Logical shapes of the token-level inputs for this (arch, shape)."""
    B = shape.global_batch
    out: Dict[str, Tuple] = {}
    if shape.kind == "train":
        out["tokens"] = (B, shape.seq_len)
        out["labels"] = (B, shape.seq_len)
    elif shape.kind == "prefill":
        out["tokens"] = (B, shape.seq_len)
    else:  # decode: ONE new token
        out["tokens"] = (B, 1)
    if cfg.frontend is not None and cfg.frontend.kind == "vision" \
            and shape.kind in ("train", "prefill"):
        out["frontend_embeds"] = (B, cfg.frontend.num_tokens, cfg.d_model)
    if cfg.encoder is not None and shape.kind in ("train", "prefill"):
        out["frames"] = (B, cfg.encoder.num_positions, cfg.d_model)
    return out


def input_specs(cfg: ModelConfig, shape: InputShape,
                dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    """The batch dict on the meta device: int32 tokens and labels, the
    stubs' embeddings in ``dtype``."""
    return {name: torch.empty(shp, device="meta",
                              dtype=torch.int32 if name in ("tokens",
                                                            "labels")
                              else dtype)
            for name, shp in batch_shapes(cfg, shape).items()}


def cache_template(cfg: ModelConfig, shape: InputShape,
                   dtype=torch.bfloat16, ring_chunk: int = 4096,
                   kv_quant: bool = False) -> Dict:
    """The ``init_cache`` dict on the meta device for a prefill or decode
    shape: capacity ``seq_len``; decode rings sized for ``ring_chunk``
    tokens a call, a prefill's for one chunk of ``seq_len`` (a single
    32k prefill call writes everything). ``kv_quant``: the int8 cache."""
    assert shape.kind in ("prefill", "decode")
    chunk = ring_chunk if shape.kind == "decode" else shape.seq_len
    return init_cache(cfg, shape.global_batch, max_len=shape.seq_len,
                      dtype=dtype, chunk=chunk, kv_quant=kv_quant,
                      device="meta")
