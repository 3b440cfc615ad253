"""Architecture registry of the port: ``get_config(arch_id, shape)``.

The port serves the dense llama-architecture decoders, the
sliding-window decoder gemma3-4b, pure Mamba2, the mixture-of-experts
decoders and the attention + Mamba2 + MoE hybrid. As in the JAX registry
(``repro.configs``), the ``long_500k`` shape turns every full-attention
layer of the ``SWA_500K_ARCHS`` into a sliding-window layer (the
``swa_500k`` variant). The two architectures of the JAX registry left in
``NOT_PORTED`` wait for their model code. The paper's own models
(``paper_models``: ``LLAMA3_8B``, ``QWEN_7B``) are imported as a module,
not through the registry, as in the JAX package.
"""
from __future__ import annotations

from repro_torch.models.config import ModelConfig

from . import (dbrx_132b, gemma3_4b, granite_8b, jamba_v0_1_52b,
               llama3_2_3b, mamba2_370m, qwen3_moe_30b_a3b, starcoder2_15b)

_CONFIGS = {"llama3.2-3b": llama3_2_3b.CONFIG,
            "mamba2-370m": mamba2_370m.CONFIG,
            "qwen3-moe-30b-a3b": qwen3_moe_30b_a3b.CONFIG,
            "dbrx-132b": dbrx_132b.CONFIG,
            "jamba-v0.1-52b": jamba_v0_1_52b.CONFIG,
            "granite-8b": granite_8b.CONFIG,
            "starcoder2-15b": starcoder2_15b.CONFIG,
            "gemma3-4b": gemma3_4b.CONFIG}

# the JAX registry's other architectures, and what each waits for
NOT_PORTED = {"internvl2-76b": "the vision frontend",
              "whisper-medium": "the encoder-decoder path"}

# full-attention archs that run long_500k via the swa_500k variant (the
# JAX registry's set, internvl2-76b included)
SWA_500K_ARCHS = frozenset({
    "qwen3-moe-30b-a3b", "llama3.2-3b", "granite-8b", "internvl2-76b",
    "dbrx-132b", "starcoder2-15b",
})


def get_config(arch_id: str, shape: str | None = None) -> ModelConfig:
    """The config of ``arch_id``, with the swa_500k variant applied when
    ``shape`` (an input shape's name) is ``long_500k`` and the arch is
    natively full attention, as the JAX registry resolves it."""
    if arch_id in NOT_PORTED:
        raise NotImplementedError(
            f"{arch_id!r} is not served by the port yet: it waits for "
            f"{NOT_PORTED[arch_id]} (ROADMAP.md queue 1)")
    if arch_id not in _CONFIGS:
        raise KeyError(f"unknown arch {arch_id!r}; the port serves "
                       f"{list(_CONFIGS)}")
    cfg = _CONFIGS[arch_id]
    if shape == "long_500k" and arch_id in SWA_500K_ARCHS:
        cfg = cfg.with_variant("swa_500k")
    return cfg


__all__ = ["get_config", "NOT_PORTED", "SWA_500K_ARCHS"]
