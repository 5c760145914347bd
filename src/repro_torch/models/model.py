"""Language-model wrapper: embeddings, the layer stack, the head, the loss,
and the entry points of training (``forward``, ``loss_fn``) and serving
(``prefill``, ``decode_step``) (``repro.models.model``).

Params are a dict: ``embed.embedding`` [V, d] (with tied embeddings it is
also the head), ``head.kernel`` [d, V] (untied only), ``ln_f.scale`` and
``layers`` (a list of per-layer block dicts).
Every leaf is an f32 master; ``working_params`` makes the copy the steps
compute with.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from .config import ModelConfig
from .layers import dense, dense_init, embed, embedding_init, rmsnorm, rmsnorm_init
from .transformer import block_init, stack_apply, stack_caches

_MATMUL_LEAVES = ("kernel", "bias", "embedding")


def lm_init(gen: torch.Generator, cfg: ModelConfig, device=None) -> dict:
    """Random f32 params from ``gen`` (which must live on ``device``)."""
    params = {
        "embed": embedding_init(gen, cfg.vocab_size, cfg.d_model, device),
        "layers": [block_init(gen, cfg, device) for _ in range(cfg.num_layers)],
        "ln_f": rmsnorm_init(cfg.d_model, device),
    }
    if not cfg.tie_embeddings:
        params["head"] = dense_init(gen, cfg.d_model, cfg.vocab_size, scale=0.02,
                                    device=device)
    return params


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
    """LM head in ``x.dtype``: its own dense, or ``x @ embedding.T`` when
    the embeddings are tied (no ``head`` params)."""
    if "head" in params:
        return dense(params["head"], x)
    return x @ params["embed"]["embedding"].T.to(x.dtype)


def forward(params, batch: dict, cfg: ModelConfig, *, use_window: bool = False):
    """Full-sequence forward of ``batch["tokens"]`` [B, S].  Returns
    (logits [B, S, V] f32, aux loss); a dense model has no aux loss."""
    h = _embed_tokens(params, batch["tokens"], cfg)
    B, S = h.shape[:2]
    positions = torch.arange(S, device=h.device).expand(B, S)
    h, _ = stack_apply(params["layers"], h, positions, cfg, use_window=use_window)
    h = rmsnorm(params["ln_f"], h, cfg.norm_eps)
    return _head(params, h).float(), torch.zeros((), device=h.device)


def _masked_ce(logits: torch.Tensor, labels: torch.Tensor):
    """Returns (sum of -log p over the labels >= 0, their count)."""
    mask = (labels >= 0).float()
    lp = torch.log_softmax(logits, dim=-1)
    ll = torch.gather(lp, -1, labels.clamp(min=0).long()[..., None])[..., 0]
    return -torch.sum(ll * mask), torch.sum(mask)


def _chunk_loss(params, hs, ls):
    return _masked_ce(_head(params, hs).float(), ls)


def loss_fn(params, batch: dict, cfg: ModelConfig):
    """Next-token cross-entropy with -1-masked labels.  Returns (total,
    {"loss", "aux"}).

    With ``cfg.ce_chunk > 0`` the head and the cross-entropy run over
    sequence chunks, each under ``torch.utils.checkpoint``, so the
    ``[T, V]`` logits are never held whole (forward or backward)."""
    labels = batch["labels"]
    if cfg.ce_chunk:
        h = _embed_tokens(params, batch["tokens"], cfg)
        B, S = h.shape[:2]
        positions = torch.arange(S, device=h.device).expand(B, S)
        h, _ = stack_apply(params["layers"], h, positions, cfg)
        h = rmsnorm(params["ln_f"], h, cfg.norm_eps)
        aux = torch.zeros((), device=h.device)
        C = cfg.ce_chunk
        nc = -(-S // C)
        pad = nc * C - S
        if pad:
            h = torch.nn.functional.pad(h, (0, 0, 0, pad))
            labels = torch.nn.functional.pad(labels, (0, pad), value=-1)
        tot = torch.zeros((), device=h.device)
        cnt = torch.zeros((), device=h.device)
        for c in range(nc):
            s, n = checkpoint(_chunk_loss, params, h[:, c * C:(c + 1) * C],
                              labels[:, c * C:(c + 1) * C], use_reentrant=False)
            tot, cnt = tot + s, cnt + n
        loss = tot / torch.clamp(cnt, min=1.0)
    else:
        logits, aux = forward(params, batch, cfg)
        s, c = _masked_ce(logits, labels)
        loss = s / torch.clamp(c, min=1.0)
    return loss + aux, {"loss": loss, "aux": aux}


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
