"""jamba-v0.1-52b [hybrid] — 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=65536, MoE 16e top-2 — Mamba+attn 1:7 interleave.  [arXiv:2403.19887]

Layer pattern (Jamba period-8 block): attention at offset 4 of each 8-layer
block (1 attn : 7 mamba); MoE FFN on every other layer.
"""
from repro_torch.models.config import (DENSE, MAMBA, MOE, LayerSpec,
                                       MoEConfig, ModelConfig, SSMConfig)

_layers = tuple(
    LayerSpec(mixer=("attn" if i % 8 == 4 else MAMBA),
              ffn=(MOE if i % 2 == 1 else DENSE))
    for i in range(32)
)

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    arch_type="hybrid",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=65536,
    layers=_layers,
    moe=MoEConfig(num_experts=16, top_k=2, d_ff_expert=14336),
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2, headdim=64, chunk=256),
    rope_theta=10_000.0,
    source="arXiv:2403.19887",
)
