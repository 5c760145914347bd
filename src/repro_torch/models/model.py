"""Language-model wrapper for the serving path: embeddings, the layer
stack, the head, ``prefill`` and ``decode_step`` (``repro.models.model``).

Params are a dict: ``embed.embedding`` [V, d] (tied: it is also the
head), ``ln_f.scale`` and ``layers`` (a list of per-layer block dicts).
Every leaf is an f32 master; ``working_params`` makes the copy the steps
compute with.
"""

from __future__ import annotations

import torch

from .config import ModelConfig
from .layers import embed, embedding_init, rmsnorm, rmsnorm_init
from .transformer import block_init, stack_apply, stack_caches

_MATMUL_LEAVES = ("kernel", "bias", "embedding")


def lm_init(gen: torch.Generator, cfg: ModelConfig, device=None) -> dict:
    """Random f32 params from ``gen`` (which must live on ``device``)."""
    return {
        "embed": embedding_init(gen, cfg.vocab_size, cfg.d_model, device),
        "layers": [block_init(gen, cfg, device) for _ in range(cfg.num_layers)],
        "ln_f": rmsnorm_init(cfg.d_model, device),
    }


def working_params(params, dtype: torch.dtype):
    """The params with every matmul operand (``kernel``, ``bias``,
    ``embedding``) cast once to the compute dtype.  Each layer casts those
    operands to its input's dtype on every call, so this copy rounds the
    same way and saves the per-call cast; norm scales stay f32 because
    ``rmsnorm`` multiplies in f32."""
    if isinstance(params, dict):
        return {k: (v.to(dtype) if k in _MATMUL_LEAVES else working_params(v, dtype))
                for k, v in params.items()}
    if isinstance(params, list):
        return [working_params(v, dtype) for v in params]
    return params


def _embed_tokens(params, tokens, cfg: ModelConfig) -> torch.Tensor:
    return embed(params["embed"], tokens, cfg.dtype)


def _head(params, x) -> torch.Tensor:
    """Tied LM head: ``x @ embedding.T`` in ``x.dtype``."""
    return x @ params["embed"]["embedding"].T.to(x.dtype)


def init_decode_caches(cfg: ModelConfig, batch: int, max_len: int,
                       dtype=torch.bfloat16, device=None) -> list:
    return stack_caches(cfg, batch, max_len, dtype, device)


def prefill(params, batch: dict, caches: list, cfg: ModelConfig, *,
            use_window: bool = False):
    """Process a prompt ``batch["tokens"]`` [B, S], filling the caches from
    position 0.  Returns (logits of the last position [B, 1, V] f32, caches)."""
    h = _embed_tokens(params, batch["tokens"], cfg)
    B, S = h.shape[:2]
    positions = torch.arange(S, device=h.device).expand(B, S)
    h, caches = stack_apply(params["layers"], h, positions, cfg, caches=caches,
                            cache_index=0, use_window=use_window)
    h = rmsnorm(params["ln_f"], h[:, -1:], cfg.norm_eps)
    return _head(params, h).float(), caches


def decode_step(params, tokens: torch.Tensor, caches: list, index: int,
                cfg: ModelConfig, *, use_window: bool = False):
    """One serving step: tokens [B, 1] at position ``index`` (a Python int)
    against the caches.  Returns (logits [B, 1, V] f32, caches)."""
    h = _embed_tokens(params, tokens, cfg)
    B = h.shape[0]
    positions = torch.full((B, 1), index, device=h.device)
    h, caches = stack_apply(params["layers"], h, positions, cfg, caches=caches,
                            cache_index=index, use_window=use_window)
    h = rmsnorm(params["ln_f"], h, cfg.norm_eps)
    return _head(params, h).float(), caches


def param_count(params) -> int:
    if isinstance(params, dict):
        return sum(param_count(v) for v in params.values())
    if isinstance(params, list):
        return sum(param_count(v) for v in params)
    return params.numel()
