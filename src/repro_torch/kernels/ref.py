"""Plain PyTorch versions of the port's kernels (the allclose ground truth).

Each computes the same function as its CUDA kernel, in f32, by a full
materialized softmax.  The wrappers in ``ops.py`` take them for tensors on
the CPU; ``chip_smoke.py`` holds each kernel against them on the card.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30


def flash_attention_ref(q, k, v, *, causal: bool = True,
                        window: Optional[int] = None):
    """q [B,Sq,H,hd], k/v [B,Sk,K,hd] (GQA: head h reads KV head h // G)."""
    B, Sq, H, hd = q.shape
    Sk, K = k.shape[1], k.shape[2]
    G = H // K
    qg = q.reshape(B, Sq, K, G, hd).float()
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float()) / math.sqrt(hd)
    qpos = torch.arange(Sq, device=q.device)[:, None]
    kpos = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    s = torch.where(mask, s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskd->bqkgd", w, v.float())
    return o.reshape(B, Sq, H, hd).to(q.dtype)


def flash_decode_ref(q, k_cache, v_cache, length: int, *,
                     window: Optional[int] = None):
    """q [B,1,H,hd]; k/v_cache [B,S,K,hd]; attends to positions < length,
    and with a window to positions >= length - window."""
    B, _, H, hd = q.shape
    S, K = k_cache.shape[1], k_cache.shape[2]
    G = H // K
    qg = q.reshape(B, 1, K, G, hd).float()
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k_cache.float()) / math.sqrt(hd)
    pos = torch.arange(S, device=q.device)
    valid = pos < length
    if window is not None:
        valid &= pos >= length - window
    s = torch.where(valid, s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskd->bqkgd", w, v_cache.float())
    return o.reshape(B, 1, H, hd).to(q.dtype)
