"""qwen3-moe-30b-a3b [moe] — 48L d_model=2048 32H (GQA kv=4) d_ff=768(expert)
vocab=151936, MoE 128 experts top-8.  [hf:Qwen/Qwen3-30B-A3B]"""
from repro_torch.models.config import (MOE, LayerSpec, MoEConfig,
                                       ModelConfig)

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b",
    arch_type="moe",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=4,
    head_dim=64,
    d_ff=768,
    vocab_size=151936,
    layers=tuple(LayerSpec("attn", MOE) for _ in range(48)),
    moe=MoEConfig(num_experts=128, top_k=8, d_ff_expert=768),
    rope_theta=1_000_000.0,
    source="hf:Qwen/Qwen3-30B-A3B",
)
