"""Grouped-query attention with RoPE, qk-norm, QKV bias, sliding window and
KV caches (``repro.models.attention``).

Execution paths:
  * ``attention_ref``      — naive O(S^2) materialized scores (plain version).
  * ``attention_chunked``  — online softmax over KV chunks, each chunk under
                             ``torch.utils.checkpoint``: the training path,
                             plain PyTorch with autograd, as the reference's
                             is jnp (K2 has no backward in the reference).
  * ``decode_attend``      — attention of a few tokens against the cache
                             (plain version of the reference's serving math).
  * ``attention_apply`` without a cache runs ``attention_chunked``; with a
    cache it is the serving path: a prompt at cache index 0 runs
    ``ops.flash_attention`` over its own k/v (the port of K2), one token
    runs ``ops.flash_decode`` over the cache (the port of K5).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from torch.utils.checkpoint import checkpoint

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
    chunk: int = 512


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


# ------------------------------------------------------ chunked online softmax

def _chunk_step(m, l, acc, q32, kci, vci, ci: int, chunk: int, Sk: int, causal: bool,
                window: Optional[int]):
    """One KV chunk of the online softmax: (m, l, acc) -> updated."""
    groups = q32.shape[2] // kci.shape[2]
    kx = kci.repeat_interleave(groups, dim=2).float()      # [B, chunk, H, hd]
    vx = vci.repeat_interleave(groups, dim=2).float()
    s = torch.einsum("bqhd,bkhd->bhqk", q32, kx)            # [B, H, Sq, chunk]
    Sq = q32.shape[1]
    kpos = ci * chunk + torch.arange(chunk, device=q32.device)[None, :]
    qpos = torch.arange(Sq, device=q32.device)[:, None]
    mask = (kpos <= Sk - 1).expand(Sq, chunk)              # padding mask
    if causal:
        mask = mask & (kpos <= qpos)
    if window is not None:
        mask = mask & (kpos > qpos - window)
    s = torch.where(mask, s, NEG_INF)
    m_new = torch.maximum(m, s.amax(dim=-1))
    alpha = torch.exp(m - m_new)
    p = torch.exp(s - m_new[..., None])
    l_new = l * alpha + p.sum(dim=-1)
    pv = torch.einsum("bhqk,bkhd->bqhd", p, vx)
    acc_new = acc * alpha.transpose(1, 2)[..., None] + pv
    return m_new, l_new, acc_new


def attention_chunked(q, k, v, *, causal: bool = True, window: Optional[int] = None,
                      chunk: int = 512):
    """Flash-style online softmax over KV chunks (plain PyTorch).

    Each chunk's step runs under ``torch.utils.checkpoint``, as the
    reference checkpoints its scan body: the backward recomputes the score
    tile of a chunk instead of saving every chunk's, so both passes hold
    O(Sq * chunk) scores.  Equal to ``attention_ref`` up to float
    associativity.
    """
    B, Sq, H, hd = q.shape
    Sk = k.shape[1]
    chunk = min(chunk, Sk)
    n_chunks = -(-Sk // chunk)
    pad = n_chunks * chunk - Sk
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    q32 = q.float() / math.sqrt(hd)
    m = torch.full((B, H, Sq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, H, Sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, Sq, H, hd), dtype=torch.float32, device=q.device)
    for ci in range(n_chunks):
        sl = slice(ci * chunk, (ci + 1) * chunk)
        m, l, acc = checkpoint(_chunk_step, m, l, acc, q32, k[:, sl], v[:, sl], ci, chunk,
                               Sk, causal, window, use_reentrant=False)
    out = acc / torch.clamp(l, min=1e-30).transpose(1, 2)[..., None]
    return out.to(q.dtype)


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
                    *, cache=None, cache_index: int = 0, use_window: bool = False):
    """Self-attention block body.  Returns (out, cache), the cache updated
    in place (``None`` without a cache).

    Without a cache (training) the sequence attends causally to itself
    through ``attention_chunked``.  With one, a prompt written at
    ``cache_index`` 0 attends causally over its own k/v only, which is what
    the reference's masked attention over the zero-filled cache computes;
    the k/v are read after the cast to the cache dtype, as the reference
    reads them from the cache.  A single token attends over the first
    ``cache_index + 1`` cache positions.
    """
    window = cfg.sliding_window if use_window else None
    q, k, v = _project_qkv(p, x, positions, cfg)
    B, S = x.shape[:2]
    if cache is None:
        out = attention_chunked(q, k, v, causal=True, window=window, chunk=cfg.chunk)
        out = out.reshape(B, S, cfg.num_heads * cfg.head_dim)
        return dense(p["wo"], out), None
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
