"""gemma3-4b [dense] — 34L d_model=2560 8H (GQA kv=4) d_ff=10240
vocab=262144 — 5:1 local:global sliding window, 128k ctx.
[hf:google/gemma-3-1b-pt]

Pattern: 5 sliding-window (1024) layers then 1 global layer, repeating.
The SWA layers use ring KV caches, which is what makes the long_500k decode
shape natively tractable (DESIGN.md §Skips).
"""
from repro_torch.models.config import ATTN, SWA, LayerSpec, ModelConfig

_layers = tuple(
    LayerSpec(mixer=(ATTN if (i + 1) % 6 == 0 else SWA),
              window=(None if (i + 1) % 6 == 0 else 1024))
    for i in range(34)
)

CONFIG = ModelConfig(
    name="gemma3-4b",
    arch_type="dense",
    num_layers=34,
    d_model=2560,
    num_heads=8,
    num_kv_heads=4,
    head_dim=256,
    d_ff=10240,
    vocab_size=262144,
    layers=_layers,
    rope_theta=1_000_000.0,
    source="hf:google/gemma-3-1b-pt",
)
