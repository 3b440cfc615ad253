"""internvl2-76b [vlm] — 80L d_model=8192 64H (GQA kv=8) d_ff=28672
vocab=128256 — InternViT + InternLM2/Llama3 backbone.  [arXiv:2404.16821]

The ViT vision encoder + projector is a STUB (assignment carve-out): the
config declares a vision frontend of 256 patch embeddings which
``input_specs()`` provides precomputed with shape [B, 256, d_model]; this
module implements the language transformer that consumes them.
"""
from repro_torch.models.config import (FrontendStub, ModelConfig,
                                       uniform_layers)

CONFIG = ModelConfig(
    name="internvl2-76b",
    arch_type="vlm",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=28672,
    vocab_size=128256,
    layers=uniform_layers(80),
    frontend=FrontendStub(kind="vision", num_tokens=256),
    rope_theta=500_000.0,
    source="arXiv:2404.16821",
)
