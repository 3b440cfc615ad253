"""Architecture registry of the port: ``get_config(arch_id, shape)``.

The port serves every architecture of the JAX registry
(``repro.configs``): the dense llama-architecture decoders, the
sliding-window decoder gemma3-4b, pure Mamba2, the mixture-of-experts
decoders, the attention + Mamba2 + MoE hybrid, the vision-language
internvl2-76b (its vision frontend a stub) and the encoder-decoder
whisper-medium (its audio frontend a stub; served by the reference
engine only, as in JAX). As in the JAX registry, the ``long_500k`` shape
turns every full-attention layer of the ``SWA_500K_ARCHS`` into a
sliding-window layer (the ``swa_500k`` variant). ``NOT_PORTED`` is
empty. The paper's own models (``paper_models``: ``LLAMA3_8B``,
``QWEN_7B``) are imported as a module, not through the registry, as in
the JAX package. ``SHAPES`` and ``InputShape`` (``shapes.py``, a copy)
are the four assigned input shapes that the training script and the
launch tools (``launch/dryrun.py``) name; ``ARCH_IDS``, ``SKIPS`` and
``all_pairs`` are the JAX registry's, in its order.
"""
from __future__ import annotations

from repro_torch.models.config import ModelConfig

from . import (dbrx_132b, gemma3_4b, granite_8b, internvl2_76b,
               jamba_v0_1_52b, llama3_2_3b, mamba2_370m, qwen3_moe_30b_a3b,
               starcoder2_15b, whisper_medium)
from .shapes import (DECODE_32K, LONG_500K, PREFILL_32K, SHAPES, TRAIN_4K,
                     InputShape)

# in the JAX registry's order (its ``ARCH_IDS``)
_CONFIGS = {"qwen3-moe-30b-a3b": qwen3_moe_30b_a3b.CONFIG,
            "llama3.2-3b": llama3_2_3b.CONFIG,
            "granite-8b": granite_8b.CONFIG,
            "jamba-v0.1-52b": jamba_v0_1_52b.CONFIG,
            "mamba2-370m": mamba2_370m.CONFIG,
            "internvl2-76b": internvl2_76b.CONFIG,
            "dbrx-132b": dbrx_132b.CONFIG,
            "starcoder2-15b": starcoder2_15b.CONFIG,
            "gemma3-4b": gemma3_4b.CONFIG,
            "whisper-medium": whisper_medium.CONFIG}

ARCH_IDS = tuple(_CONFIGS)

# (arch, shape) pairs that do not run, and why
SKIPS = {
    ("whisper-medium", "long_500k"):
        "enc-dec over bounded 30s audio; decoder length bounded by "
        "construction — no 500k decode exists for this family",
}

# the JAX registry's architectures the port does not serve, and what each
# waits for: none
NOT_PORTED: dict = {}

# full-attention archs that run long_500k via the swa_500k variant (the
# JAX registry's set, internvl2-76b included)
SWA_500K_ARCHS = frozenset({
    "qwen3-moe-30b-a3b", "llama3.2-3b", "granite-8b", "internvl2-76b",
    "dbrx-132b", "starcoder2-15b",
})


def get_config(arch_id: str, shape: InputShape | str | None = None
               ) -> ModelConfig:
    """The config of ``arch_id``, with the swa_500k variant applied when
    ``shape`` (an input shape or its name) is ``long_500k`` and the arch
    is natively full attention, as the JAX registry resolves it."""
    if arch_id not in _CONFIGS:
        raise KeyError(f"unknown arch {arch_id!r}; the port serves "
                       f"{list(_CONFIGS)}")
    cfg = _CONFIGS[arch_id]
    sname = shape.name if isinstance(shape, InputShape) else shape
    if sname == "long_500k" and arch_id in SWA_500K_ARCHS:
        cfg = cfg.with_variant("swa_500k")
    return cfg


def all_pairs():
    """All (arch_id, shape) combinations minus ``SKIPS``, cheap to trace
    first (decode < prefill < train), as the JAX registry orders them."""
    cost = {"decode_32k": 0, "long_500k": 1, "prefill_32k": 2,
            "train_4k": 3}
    out = [(a, s) for a in ARCH_IDS for s in SHAPES.values()
           if (a, s.name) not in SKIPS]
    out.sort(key=lambda p: (cost.get(p[1].name, 9), p[0]))
    return out


__all__ = ["ARCH_IDS", "SKIPS", "get_config", "all_pairs", "NOT_PORTED",
           "SWA_500K_ARCHS", "SHAPES", "InputShape", "TRAIN_4K",
           "PREFILL_32K", "DECODE_32K", "LONG_500K"]
