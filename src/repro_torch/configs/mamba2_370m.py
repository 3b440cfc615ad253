"""mamba2-370m [ssm] — 48L d_model=1024 (attn-free) d_ff=0 vocab=50280,
ssm_state=128 — SSD (state-space duality).  [arXiv:2405.21060]

Pure-SSM blocks: Mamba2 mixer, no separate FFN (d_ff=0). Vocab padded
50280 -> 50432 for clean 16-way sharding.
"""
from repro_torch.models.config import (MAMBA, NONE, LayerSpec, ModelConfig,
                                       SSMConfig)

CONFIG = ModelConfig(
    name="mamba2-370m",
    arch_type="ssm",
    num_layers=48,
    d_model=1024,
    num_heads=0,
    num_kv_heads=0,
    head_dim=0,
    d_ff=0,
    vocab_size=50280,
    layers=tuple(LayerSpec(MAMBA, NONE) for _ in range(48)),
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, headdim=64, chunk=256),
    tie_embeddings=True,
    source="arXiv:2405.21060",
)
