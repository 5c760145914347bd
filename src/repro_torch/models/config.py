"""Model configuration shared by model code and the per-arch config files.

The fields of ``repro.models.config.ModelConfig`` that the port's dense
serving and training paths read, with ``dtype`` and ``dude_buffer_dtype``
torch dtypes.  A model is a stack of ``num_layers`` attention + gated-MLP
blocks, with its LM head tied to the embedding or a dense of its own; the
other block kinds and their fields come with the slices that port them.
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
    tie_embeddings: bool = False        # the head is the embedding (else its own dense)
    attn_chunk: int = 512               # KV chunk of the training attention
    norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16  # compute and KV-cache dtype
    remat: bool = True                  # recompute each layer in the backward
    ce_chunk: int = 0                   # LM head + CE in sequence chunks (0 = off)
    n_workers: int = 16                 # DuDe workers of this arch
    dude_buffer_dtype: torch.dtype = torch.bfloat16   # engine slab dtype
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
            attn_chunk=32,
            dtype=torch.float32,
            remat=False,
            n_workers=4,
        )
