"""Model configuration shared by model code and the per-arch config files.

The fields of ``repro.models.config.ModelConfig`` that the port's dense
serving path reads, with ``dtype`` a torch dtype.  A model is a stack of
``num_layers`` attention + gated-MLP blocks with tied embeddings; the other
block kinds and their fields come with the slices that port them.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None      # default d_model // num_heads
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 1e4
    sliding_window: Optional[int] = None
    norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16  # compute and KV-cache dtype
    source: str = ""                    # citation of the published config

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    def smoke(self) -> "ModelConfig":
        """Reduced variant for CPU tests: the reduction of
        ``repro.models.config.ModelConfig.smoke`` for a dense model."""
        return dataclasses.replace(
            self,
            num_layers=2,
            d_model=256,
            num_heads=4,
            num_kv_heads=max(1, min(self.num_kv_heads, 2)),
            head_dim=64,
            d_ff=512,
            vocab_size=512,
            sliding_window=64 if self.sliding_window else None,
            dtype=torch.float32,
        )
