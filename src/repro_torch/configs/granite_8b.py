"""granite-8b [dense] — 36L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=49152 — llama-arch, code.  [arXiv:2405.04324]"""
from repro_torch.models.config import ModelConfig, uniform_layers

CONFIG = ModelConfig(
    name="granite-8b",
    arch_type="dense",
    num_layers=36,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=49152,
    layers=uniform_layers(36),
    rope_theta=10_000.0,
    source="arXiv:2405.04324",
)
