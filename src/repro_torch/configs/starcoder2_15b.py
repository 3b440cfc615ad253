"""starcoder2-15b [dense] — 40L d_model=6144 48H (GQA kv=4) d_ff=24576
vocab=49152 — GQA, RoPE.  [arXiv:2402.19173]"""
from repro_torch.models.config import ModelConfig, uniform_layers

CONFIG = ModelConfig(
    name="starcoder2-15b",
    arch_type="dense",
    num_layers=40,
    d_model=6144,
    num_heads=48,
    num_kv_heads=4,
    head_dim=128,
    d_ff=24576,
    vocab_size=49152,
    layers=uniform_layers(40),
    rope_theta=100_000.0,
    source="arXiv:2402.19173",
)
