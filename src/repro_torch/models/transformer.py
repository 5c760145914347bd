"""Block assembly for the dense ``"attn"`` layer kind, run as a plain loop
over layers (the reference scans over period groups; with one layer kind
per period a group is one layer).  Without caches (training) each layer
runs under ``torch.utils.checkpoint`` when ``cfg.remat`` is set, as the
reference checkpoints each group.  MoE, SSM and hybrid kinds wait for a
later slice.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from .attention import AttnConfig, attention_apply, attention_init, init_cache
from .config import ModelConfig
from .layers import mlp, mlp_init, rmsnorm, rmsnorm_init


def attn_cfg(cfg: ModelConfig) -> AttnConfig:
    return AttnConfig(
        d_model=cfg.d_model, num_heads=cfg.num_heads,
        num_kv_heads=cfg.num_kv_heads, head_dim=cfg.hd,
        qkv_bias=cfg.qkv_bias, qk_norm=cfg.qk_norm,
        rope_theta=cfg.rope_theta, sliding_window=cfg.sliding_window,
    )


def block_init(gen: torch.Generator, cfg: ModelConfig, device=None):
    d = cfg.d_model
    return {
        "ln1": rmsnorm_init(d, device), "attn": attention_init(gen, attn_cfg(cfg), device),
        "ln2": rmsnorm_init(d, device), "mlp": mlp_init(gen, d, cfg.d_ff, device),
    }


def block_apply(params, x, positions, cfg: ModelConfig, *, cache=None,
                cache_index: int = 0, use_window: bool = False):
    """Residual attention + MLP block.  Returns (x, cache)."""
    h, cache = attention_apply(
        params["attn"], rmsnorm(params["ln1"], x, cfg.norm_eps), positions,
        attn_cfg(cfg), cache=cache, cache_index=cache_index, use_window=use_window,
    )
    x = x + h
    x = x + mlp(params["mlp"], rmsnorm(params["ln2"], x, cfg.norm_eps))
    return x, cache


def stack_caches(cfg: ModelConfig, batch: int, max_len: int,
                 dtype=torch.bfloat16, device=None) -> list:
    """One KV cache per layer (the reference stacks them on a leading axis)."""
    return [init_cache(batch, max_len, cfg.num_kv_heads, cfg.hd, dtype, device)
            for _ in range(cfg.num_layers)]


def _block_train(layer, x, positions, cfg: ModelConfig, use_window: bool):
    return block_apply(layer, x, positions, cfg, use_window=use_window)[0]


def stack_apply(layers: list, x, positions, cfg: ModelConfig, *,
                caches: Optional[list] = None, cache_index: int = 0,
                use_window: bool = False):
    """Run every layer in order.  Returns (x, caches), the caches updated in
    place (``None`` without caches)."""
    if caches is None:
        for layer in layers:
            if cfg.remat:
                x = checkpoint(_block_train, layer, x, positions, cfg, use_window,
                               use_reentrant=False)
            else:
                x = _block_train(layer, x, positions, cfg, use_window)
        return x, None
    for layer, cache in zip(layers, caches):
        x, _ = block_apply(layer, x, positions, cfg, cache=cache,
                           cache_index=cache_index, use_window=use_window)
    return x, caches
