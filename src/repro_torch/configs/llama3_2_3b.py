"""llama3.2-3b [dense] — 28L d_model=3072 24H (GQA kv=8) d_ff=8192
vocab=128256 — small llama3.  [hf:meta-llama/Llama-3.2-1B]"""
from repro_torch.models.config import ModelConfig, uniform_layers

CONFIG = ModelConfig(
    name="llama3.2-3b",
    arch_type="dense",
    num_layers=28,
    d_model=3072,
    num_heads=24,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=128256,
    layers=uniform_layers(28),
    rope_theta=500_000.0,
    source="hf:meta-llama/Llama-3.2-1B",
)
