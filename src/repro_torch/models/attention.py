"""Grouped-query attention with RoPE, qk-norm, QKV bias, sliding window and
KV caches: the serving path of ``repro.models.attention``.

Execution paths:
  * ``attention_ref``  — naive O(S^2) materialized scores (plain version).
  * ``decode_attend``  — attention of a few tokens against the cache (plain
                         version of the reference's serving math).
  * ``attention_apply`` with a cache — the serving path: a prompt at cache
    index 0 runs ``ops.flash_attention`` over its own k/v (the port of K2),
    one token runs ``ops.flash_decode`` over the cache (the port of K5).

The cache-free training path (``attention_chunked``) waits for the
training slice.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from ..kernels import ops
from .layers import apply_rope, dense, dense_init, rmsnorm, rmsnorm_init

NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class AttnConfig:
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 1e4
    sliding_window: Optional[int] = None


def attention_init(gen: torch.Generator, cfg: AttnConfig, device=None):
    H, K, hd, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.d_model
    p = {
        "wq": dense_init(gen, d, H * hd, bias=cfg.qkv_bias, device=device),
        "wk": dense_init(gen, d, K * hd, bias=cfg.qkv_bias, device=device),
        "wv": dense_init(gen, d, K * hd, bias=cfg.qkv_bias, device=device),
        "wo": dense_init(gen, H * hd, d, device=device),
    }
    if cfg.qk_norm:
        p["q_norm"] = rmsnorm_init(hd, device=device)
        p["k_norm"] = rmsnorm_init(hd, device=device)
    return p


def _project_qkv(p, x, positions, cfg: AttnConfig):
    B, S, _ = x.shape
    H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = dense(p["wq"], x).reshape(B, S, H, hd)
    k = dense(p["wk"], x).reshape(B, S, K, hd)
    v = dense(p["wv"], x).reshape(B, S, K, hd)
    if cfg.qk_norm:
        q = rmsnorm(p["q_norm"], q)
        k = rmsnorm(p["k_norm"], k)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


# --------------------------------------------------------------- plain paths

def attention_ref(q, k, v, *, causal: bool = True, window: Optional[int] = None,
                  q_offset: int = 0):
    """q [B,Sq,H,hd], k/v [B,Sk,K,hd]. Materializes full scores."""
    B, Sq, H, hd = q.shape
    Sk, K = k.shape[1], k.shape[2]
    kx = k.repeat_interleave(H // K, dim=2).float()
    vx = v.repeat_interleave(H // K, dim=2).float()
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), kx) / math.sqrt(hd)
    qpos = torch.arange(Sq, device=q.device)[:, None] + q_offset
    kpos = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    w = torch.softmax(torch.where(mask, scores, NEG_INF), dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", w, vx).to(q.dtype)


def decode_attend(q, cache, length: int, *, window: Optional[int] = None):
    """Attention of q [B, Sq, H, hd] (the last Sq of ``length`` positions)
    against the cache [B, Smax, K, hd], masked to positions < ``length``.
    Scores and weights in f32, with the weights cast to the cache dtype
    before the product with v, as in the reference."""
    B, Sq, H, hd = q.shape
    K = cache["k"].shape[2]
    qg = q.reshape(B, Sq, K, H // K, hd)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), cache["k"].float()) / math.sqrt(hd)
    kpos = torch.arange(cache["k"].shape[1], device=q.device)[None, :]
    qpos = (length - Sq) + torch.arange(Sq, device=q.device)[:, None]
    mask = kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    w = torch.softmax(torch.where(mask, s, NEG_INF), dim=-1)
    w = w.to(cache["v"].dtype).float()
    out = torch.einsum("bkgqs,bskd->bqkgd", w, cache["v"].float())
    return out.reshape(B, Sq, H, hd).to(q.dtype)


# ------------------------------------------------------------------- KV cache

def init_cache(batch: int, max_len: int, num_kv_heads: int, head_dim: int,
               dtype=torch.bfloat16, device=None):
    shape = (batch, max_len, num_kv_heads, head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def update_cache(cache, k: torch.Tensor, v: torch.Tensor, index: int):
    """Write [B, S_new, K, hd] at position ``index``, cast to the cache dtype.

    Writes in place with a slice assignment and returns the same cache.  The
    reference's position-mask ``where`` for single-token writes exists only
    so that GSPMD can update a sequence-sharded cache locally; the port has
    no such sharding.
    """
    S = k.shape[1]
    cache["k"][:, index:index + S] = k
    cache["v"][:, index:index + S] = v
    return cache


# ----------------------------------------------------------- full attn module

def attention_apply(p, x: torch.Tensor, positions: torch.Tensor, cfg: AttnConfig,
                    *, cache, cache_index: int, use_window: bool = False):
    """Self-attention block body on the serving path.  Returns
    (out, cache), the cache updated in place.

    A prompt written at ``cache_index`` 0 attends causally over its own k/v
    only, which is what the reference's masked attention over the
    zero-filled cache computes; the k/v are read after the cast to the cache
    dtype, as the reference reads them from the cache.  A single token
    attends over the first ``cache_index + 1`` cache positions.
    """
    window = cfg.sliding_window if use_window else None
    q, k, v = _project_qkv(p, x, positions, cfg)
    B, S = x.shape[:2]
    update_cache(cache, k, v, cache_index)
    if cache_index == 0:
        kc, vc = k.to(cache["k"].dtype), v.to(cache["v"].dtype)
        out = ops.flash_attention(q.to(kc.dtype), kc, vc, causal=True, window=window)
    elif S == 1:
        out = ops.flash_decode(q.to(cache["k"].dtype), cache["k"], cache["v"],
                               cache_index + 1, window=window)
    else:
        raise NotImplementedError(
            "a multi-token chunk after cache index 0 (chunked prefill) is not "
            "on the serving path")
    out = out.to(x.dtype).reshape(B, S, cfg.num_heads * cfg.head_dim)
    return dense(p["wo"], out), cache
