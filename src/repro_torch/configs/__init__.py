"""Architecture registry of the port: ``get_config(arch_id)``.

The port serves the dense llama family and the pure-Mamba2 family; every
other architecture of the JAX registry (``repro.configs``) waits for its
model code.
"""
from __future__ import annotations

from repro_torch.models.config import ModelConfig

from . import llama3_2_3b, mamba2_370m

_CONFIGS = {"llama3.2-3b": llama3_2_3b.CONFIG,
            "mamba2-370m": mamba2_370m.CONFIG}

# the JAX registry's other architectures, not yet ported
NOT_PORTED = ("qwen3-moe-30b-a3b", "granite-8b", "jamba-v0.1-52b",
              "internvl2-76b", "dbrx-132b", "starcoder2-15b", "gemma3-4b",
              "whisper-medium")


def get_config(arch_id: str) -> ModelConfig:
    if arch_id in _CONFIGS:
        return _CONFIGS[arch_id]
    if arch_id in NOT_PORTED:
        raise NotImplementedError(
            f"{arch_id!r} is not served by the port yet: its model family "
            f"waits in ROADMAP.md queue 1 (MoE, hybrid attention+Mamba, "
            f"sliding window, encoder-decoder)")
    raise KeyError(f"unknown arch {arch_id!r}; the port serves "
                   f"{list(_CONFIGS)}")


__all__ = ["get_config", "NOT_PORTED"]
