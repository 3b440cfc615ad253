"""dbrx-132b [moe] — 40L d_model=6144 48H (GQA kv=8) d_ff=10752(expert)
vocab=100352, MoE 16 experts top-4, fine-grained.  [hf:databricks/dbrx-base]"""
from repro_torch.models.config import (MOE, LayerSpec, MoEConfig,
                                       ModelConfig)

CONFIG = ModelConfig(
    name="dbrx-132b",
    arch_type="moe",
    num_layers=40,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=10752,
    vocab_size=100352,
    layers=tuple(LayerSpec("attn", MOE) for _ in range(40)),
    moe=MoEConfig(num_experts=16, top_k=4, d_ff_expert=10752),
    rope_theta=500_000.0,
    source="hf:databricks/dbrx-base",
)
