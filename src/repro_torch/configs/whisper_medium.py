"""whisper-medium [audio] — 24L d_model=1024 16H (kv=16, MHA) d_ff=4096
vocab=51865 — enc-dec, conv frontend (STUB).  [arXiv:2212.04356]

The mel-spectrogram + conv feature extractor is a STUB (assignment
carve-out): ``input_specs()`` provides precomputed frame embeddings
[B, 1500, d_model] consumed by the 24-layer bidirectional encoder; the
24-layer decoder (self-attn causal + cross-attn over encoder output) is
implemented in full. Vocab padded 51865 -> 51968.

Shape notes (DESIGN.md §Skips): decode_32k runs with a synthetic 32k decoder
self-attention cache (beyond Whisper's native 448 positions — lowering
coverage); long_500k is SKIPPED (enc-dec over bounded 30 s audio; decoder
length bounded by construction).
"""
from repro_torch.models.config import (EncoderConfig, FrontendStub,
                                       ModelConfig, uniform_layers)

CONFIG = ModelConfig(
    name="whisper-medium",
    arch_type="audio",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab_size=51865,
    layers=uniform_layers(24),
    encoder=EncoderConfig(num_layers=24, num_positions=1500),
    frontend=FrontendStub(kind="audio", num_tokens=1500),
    rope_theta=10_000.0,
    source="arXiv:2212.04356",
)
