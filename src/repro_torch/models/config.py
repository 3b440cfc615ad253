"""Model configuration system.

A single composable ``ModelConfig`` covers every assigned architecture family:
dense (GQA+RoPE+SwiGLU), MoE (GShard dispatch), SSM (Mamba2/SSD), hybrid
(Jamba-style interleave), sliding-window (Gemma3), encoder-decoder (Whisper)
and modality-stub frontends (VLM / audio).

Layers are described by a per-layer ``LayerSpec(mixer, ffn, window)`` pattern
so heterogeneous stacks (Jamba 1:7 attn:mamba, Gemma 5:1 local:global) are
first-class rather than special-cased.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple

# mixer kinds
ATTN = "attn"          # full causal attention
SWA = "swa"            # sliding-window causal attention
MAMBA = "mamba"        # Mamba2 / SSD mixer (attention-free)

# ffn kinds
DENSE = "dense"
MOE = "moe"
NONE = "none"          # pure-SSM blocks carry no separate FFN


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


@dataclass(frozen=True)
class LayerSpec:
    mixer: str = ATTN           # ATTN | SWA | MAMBA
    ffn: str = DENSE            # DENSE | MOE | NONE
    window: Optional[int] = None  # only for SWA


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    capacity_factor: float = 1.25
    router_jitter: float = 0.0


@dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    headdim: int = 64
    chunk: int = 256            # SSD chunk length

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.headdim


@dataclass(frozen=True)
class EncoderConfig:
    """Encoder stack for enc-dec models (Whisper). The modality frontend
    (mel + conv) is a STUB: the encoder consumes precomputed frame
    embeddings of shape [B, num_positions, d_model]."""
    num_layers: int
    num_positions: int = 1500   # Whisper: 30s audio -> 1500 frames


@dataclass(frozen=True)
class FrontendStub:
    """Modality frontend stub: precomputed embeddings injected at input.

    kind='vision'  -> patch embeddings prepended to the token sequence
    kind='audio'   -> frame embeddings consumed by the encoder stack
    """
    kind: str                   # "vision" | "audio"
    num_tokens: int             # patches per image / frames per clip


@dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str              # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    layers: Tuple[LayerSpec, ...]
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    encoder: Optional[EncoderConfig] = None
    frontend: Optional[FrontendStub] = None
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    # attention variant flag used by long_500k for natively-full-attention
    # archs (DESIGN.md §Skips): "native" or "swa_500k"
    attn_variant: str = "native"
    swa_500k_window: int = 8192
    source: str = ""            # citation

    # ---- derived ----
    @property
    def vocab_padded(self) -> int:
        """Vocab padded to a multiple of 256 so the vocab dim shards cleanly
        on a 16-way mesh axis (standard production practice)."""
        return _round_up(self.vocab_size, 256)

    @property
    def is_encdec(self) -> bool:
        return self.encoder is not None

    @property
    def has_attention(self) -> bool:
        return any(l.mixer in (ATTN, SWA) for l in self.layers)

    @property
    def is_subquadratic(self) -> bool:
        """True if no layer requires an unbounded full-attention KV cache."""
        return all(l.mixer != ATTN for l in self.layers)

    def layer_counts(self):
        c = {}
        for l in self.layers:
            c[l.mixer] = c.get(l.mixer, 0) + 1
        return c

    def with_variant(self, variant: str) -> "ModelConfig":
        """Return a copy with full-attention layers replaced by SWA
        (used for long_500k on natively-full-attention archs)."""
        if variant == "native":
            return self
        assert variant == "swa_500k"
        new_layers = tuple(
            dataclasses.replace(l, mixer=SWA, window=self.swa_500k_window)
            if l.mixer == ATTN else l
            for l in self.layers
        )
        return dataclasses.replace(self, layers=new_layers, attn_variant=variant)

    # ---- parameter counting (for roofline MODEL_FLOPS = 6*N*D) ----
    def param_count(self, active_only: bool = False) -> int:
        """Total (or MoE-active) parameter count, embeddings included."""
        n = self.vocab_padded * self.d_model          # embedding
        if not self.tie_embeddings:
            n += self.vocab_padded * self.d_model     # lm head
        for l in self.layers:
            n += self._mixer_params(l)
            n += self._ffn_params(l, active_only)
            n += 2 * self.d_model                     # the two norms
        if self.encoder is not None:
            for _ in range(self.encoder.num_layers):
                n += self._mixer_params(LayerSpec(ATTN, DENSE))
                n += self._ffn_params(LayerSpec(ATTN, DENSE), active_only)
                n += 2 * self.d_model
            # decoder cross-attention per decoder layer
            n += self.num_layers * self._mixer_params(LayerSpec(ATTN, DENSE))
            n += self.num_layers * self.d_model
        return n

    def _mixer_params(self, l: LayerSpec) -> int:
        if l.mixer == MAMBA:
            s = self.ssm
            d_in = s.d_inner(self.d_model)
            nh = s.n_heads(self.d_model)
            n_groups = 1
            in_proj = self.d_model * (2 * d_in + 2 * n_groups * s.d_state + nh)
            conv = (d_in + 2 * n_groups * s.d_state) * s.d_conv
            out = d_in * self.d_model
            extra = nh + nh + d_in                    # A_log, dt_bias, norm
            return in_proj + conv + out + extra
        q = self.d_model * self.num_heads * self.head_dim
        kv = 2 * self.d_model * self.num_kv_heads * self.head_dim
        o = self.num_heads * self.head_dim * self.d_model
        return q + kv + o

    def _ffn_params(self, l: LayerSpec, active_only: bool) -> int:
        if l.ffn == NONE:
            return 0
        if l.ffn == MOE:
            e = self.moe.top_k if active_only else self.moe.num_experts
            return (self.moe.num_experts * self.d_model  # router
                    + e * 3 * self.d_model * self.moe.d_ff_expert)
        return 3 * self.d_model * self.d_ff              # swiglu

    def reduced(self, num_layers: int = 2, d_model: int = 256,
                max_experts: int = 4) -> "ModelConfig":
        """A tiny same-family variant for CPU smoke tests
        (<=2 layers, d_model<=512, <=4 experts)."""
        heads = max(2, min(4, self.num_heads))
        kv = max(1, min(heads, self.num_kv_heads))
        if heads % kv:
            kv = 1
        head_dim = max(16, d_model // heads)
        layers = tuple(self.layers[:: max(1, len(self.layers) // num_layers)]
                       [:num_layers])
        # preserve family: keep at least one of each mixer kind present
        kinds = {l.mixer for l in self.layers}
        have = {l.mixer for l in layers}
        missing = list(kinds - have)
        if missing:
            layers = layers[: num_layers - len(missing)] + tuple(
                next(l for l in self.layers if l.mixer == k) for k in missing)
        layers = tuple(
            dataclasses.replace(l, window=min(l.window, 64) if l.window else None)
            for l in layers)
        moe = None
        if self.moe is not None:
            # generous capacity so smoke tests are drop-free: capacity
            # drops are batch-composition-dependent (chunked serving sees
            # different T than full-batch training), which is expected MoE
            # behaviour but would make exact-equivalence tests flaky
            moe = dataclasses.replace(
                self.moe,
                num_experts=min(max_experts, self.moe.num_experts),
                top_k=min(2, self.moe.top_k),
                d_ff_expert=d_model * 2,
                capacity_factor=4.0)
        ssm = None
        if self.ssm is not None:
            ssm = dataclasses.replace(self.ssm, d_state=32, headdim=32, chunk=32)
        enc = None
        if self.encoder is not None:
            enc = EncoderConfig(num_layers=1, num_positions=16)
        fe = None
        if self.frontend is not None:
            fe = dataclasses.replace(self.frontend, num_tokens=8)
        return dataclasses.replace(
            self, name=self.name + "-smoke", num_layers=len(layers),
            d_model=d_model, num_heads=heads, num_kv_heads=kv,
            head_dim=head_dim, d_ff=d_model * 4, vocab_size=512,
            layers=layers, moe=moe, ssm=ssm, encoder=enc, frontend=fe)


def uniform_layers(n: int, mixer: str = ATTN, ffn: str = DENSE,
                   window: Optional[int] = None) -> Tuple[LayerSpec, ...]:
    return tuple(LayerSpec(mixer, ffn, window) for _ in range(n))
