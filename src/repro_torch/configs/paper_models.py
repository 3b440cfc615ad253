"""The paper's own evaluation models (§4 Models and Hardware):
Llama3-8B (single A100) and Qwen-7B (2x A100, TP2). Used by the paper-table
benchmarks; not part of the 10 assigned architectures."""
from repro_torch.models.config import ModelConfig, uniform_layers

LLAMA3_8B = ModelConfig(
    name="llama3-8b",
    arch_type="dense",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=128256,
    layers=uniform_layers(32),
    rope_theta=500_000.0,
    source="hf:meta-llama/Meta-Llama-3-8B (paper §4)",
)

QWEN_7B = ModelConfig(
    name="qwen-7b",
    arch_type="dense",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=32,
    head_dim=128,
    d_ff=11008,
    vocab_size=151936,
    layers=uniform_layers(32),
    rope_theta=10_000.0,
    source="hf:Qwen/Qwen-7B (paper §4)",
)
