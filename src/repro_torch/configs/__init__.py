"""Architecture registry of the port: ``get_config(arch_id)``.

The port serves the dense llama-architecture decoders, pure Mamba2, the
mixture-of-experts decoders and the attention + Mamba2 + MoE hybrid.
The three architectures of the JAX registry (``repro.configs``) left in
``NOT_PORTED`` wait for their model code. The paper's own models
(``paper_models``: ``LLAMA3_8B``, ``QWEN_7B``) are imported as a module,
not through the registry, as in the JAX package.
"""
from __future__ import annotations

from repro_torch.models.config import ModelConfig

from . import (dbrx_132b, granite_8b, jamba_v0_1_52b, llama3_2_3b,
               mamba2_370m, qwen3_moe_30b_a3b, starcoder2_15b)

_CONFIGS = {"llama3.2-3b": llama3_2_3b.CONFIG,
            "mamba2-370m": mamba2_370m.CONFIG,
            "qwen3-moe-30b-a3b": qwen3_moe_30b_a3b.CONFIG,
            "dbrx-132b": dbrx_132b.CONFIG,
            "jamba-v0.1-52b": jamba_v0_1_52b.CONFIG,
            "granite-8b": granite_8b.CONFIG,
            "starcoder2-15b": starcoder2_15b.CONFIG}

# the JAX registry's other architectures, and what each waits for
NOT_PORTED = {"gemma3-4b": "the sliding-window attention path",
              "internvl2-76b": "the vision frontend",
              "whisper-medium": "the encoder-decoder path"}


def get_config(arch_id: str) -> ModelConfig:
    if arch_id in _CONFIGS:
        return _CONFIGS[arch_id]
    if arch_id in NOT_PORTED:
        raise NotImplementedError(
            f"{arch_id!r} is not served by the port yet: it waits for "
            f"{NOT_PORTED[arch_id]} (ROADMAP.md queue 1)")
    raise KeyError(f"unknown arch {arch_id!r}; the port serves "
                   f"{list(_CONFIGS)}")


__all__ = ["get_config", "NOT_PORTED"]
