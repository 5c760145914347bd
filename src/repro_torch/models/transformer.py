"""Block assembly for the dense ``"attn"`` layer kind, run as a plain loop
over layers (the reference scans over period groups; with one layer kind
per period a group is one layer).  MoE, SSM and hybrid kinds wait for a
later slice.
"""

from __future__ import annotations

import torch

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


def block_apply(params, x, positions, cfg: ModelConfig, *, cache, cache_index: int,
                use_window: bool = False):
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


def stack_apply(layers: list, x, positions, cfg: ModelConfig, *, caches: list,
                cache_index: int, use_window: bool = False):
    """Run every layer in order.  Returns (x, caches), updated in place."""
    for layer, cache in zip(layers, caches):
        x, _ = block_apply(layer, x, positions, cfg, cache=cache,
                           cache_index=cache_index, use_window=use_window)
    return x, caches
