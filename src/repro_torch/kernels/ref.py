"""Plain PyTorch versions of the port's kernels (the allclose ground truth).

Each computes the same function as its CUDA kernel: the attention kernels
in f32 by a full materialized softmax, the DuDe round row by row in the
kernel's order.  The wrappers in ``ops.py`` take them for tensors on the
CPU; ``chip_smoke.py`` holds each kernel against them on the card.
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


def dude_round_apply_ref(cm, sm, fresh, g_workers, inflight, g_bar, w, slots=(),
                         bias_corr=None, *, kind: str, hp):
    """The fused DuDe round + optimizer step (K1), in place, with K1's
    streams and op order: the commit sum runs over the rows in order, a
    committed row copies the in-flight value, a starting row latches
    ``fresh`` cast to the buffer dtype (round to nearest even), then the
    optimizer steps ``w`` and the slots on ``g``.  ``cm``/``sm`` are [n]
    masks; ``bias_corr`` is AdamW's ``[1 - b1^t, 1 - b2^t]``.  Returns
    ``(g_workers, inflight, g_bar, w, slots)``, the inputs updated."""
    hp, n = dict(hp), fresh.shape[0]
    cmf, smb = cm.to(torch.float32), sm.to(torch.bool)
    acc = torch.zeros_like(g_bar)
    for i in range(n):
        gi, vi = g_workers[i], inflight[i]
        acc = acc + cmf[i] * (vi.float() - gi.float())
        new_g = torch.where(cmf[i] > 0, vi, gi)
        new_v = torch.where(smb[i], fresh[i].to(inflight.dtype), vi)
        gi.copy_(new_g)
        vi.copy_(new_v)
    g = g_bar + acc / n
    g_bar.copy_(g)
    if kind == "sgd":
        w.copy_(w - hp["lr"] * g)
    elif kind == "momentum":
        (m_slot,) = slots
        m = hp["beta"] * m_slot + g
        d = hp["beta"] * m + g if hp["nesterov"] else m
        w.copy_(w - hp["lr"] * d)
        m_slot.copy_(m)
    elif kind == "adamw":
        m_slot, v_slot = slots
        b1, b2 = hp["b1"], hp["b2"]
        m = b1 * m_slot + (1 - b1) * g
        v = b2 * v_slot + (1 - b2) * torch.square(g)
        step = (m / bias_corr[0]) / (torch.sqrt(v / bias_corr[1]) + hp["eps"]) \
            + hp["weight_decay"] * w
        w.copy_(w - hp["lr"] * step)
        m_slot.copy_(m)
        v_slot.copy_(v)
    else:
        raise ValueError(f"unknown optimizer kind {kind!r}")
    return g_workers, inflight, g_bar, w, tuple(slots)
