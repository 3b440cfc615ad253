from .config import (ATTN, DENSE, MAMBA, MOE, NONE, SWA, LayerSpec,
                     ModelConfig, uniform_layers)

__all__ = ["ATTN", "DENSE", "MAMBA", "MOE", "NONE", "SWA", "LayerSpec",
           "ModelConfig", "uniform_layers"]
