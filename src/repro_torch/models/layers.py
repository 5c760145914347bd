"""Shared neural-net layers (plain functions on tensors, no ``nn.Module``).

Parameters are nested dicts of tensors, as in ``repro.models.layers``; the
layout of every weight is the reference's (``kernel`` is ``[d_in, d_out]``),
so the tests compare like with like.  Parameters are stored in f32; each
layer computes in the dtype of its input.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


# ----------------------------------------------------------------- init utils

def dense_init(gen: torch.Generator, d_in: int, d_out: int, *, bias: bool = False,
               scale=None, device=None):
    w = torch.randn((d_in, d_out), generator=gen, device=device)
    p = {"kernel": w / math.sqrt(d_in) if scale is None else w * scale}
    if bias:
        p["bias"] = torch.zeros((d_out,), device=device)
    return p


def dense(p, x: torch.Tensor) -> torch.Tensor:
    y = x @ p["kernel"].to(x.dtype)
    if "bias" in p:
        y = y + p["bias"].to(x.dtype)
    return y


def embedding_init(gen: torch.Generator, vocab: int, d: int, device=None):
    return {"embedding": torch.randn((vocab, d), generator=gen, device=device) * 0.02}


def embed(p, ids: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return p["embedding"][ids].to(dtype)


# ----------------------------------------------------------------------- norm

def rmsnorm_init(d: int, device=None):
    return {"scale": torch.ones((d,), device=device)}


def rmsnorm(p, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * p["scale"]).to(x.dtype)


# ------------------------------------------------------------------------ mlp

def mlp_init(gen: torch.Generator, d: int, d_ff: int, device=None):
    """Gated (SwiGLU) MLP; the draw order follows ``repro``'s key split
    (up, down, gate), though torch and JAX draw different numbers."""
    return {"up": dense_init(gen, d, d_ff, device=device),
            "down": dense_init(gen, d_ff, d, device=device),
            "gate": dense_init(gen, d, d_ff, device=device)}


def mlp(p, x: torch.Tensor) -> torch.Tensor:
    h = F.silu(dense(p["gate"], x)) * dense(p["up"], x)
    return dense(p["down"], h)


# ----------------------------------------------------------------------- rope

def rope_frequencies(head_dim: int, theta: float = 1e4, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 1e4) -> torch.Tensor:
    """x: [..., S, H, hd]; positions: [..., S].  Half-split convention
    (first half rotates against the second), angles in f32."""
    freqs = rope_frequencies(x.shape[-1], theta, device=x.device)      # [hd/2]
    angles = positions[..., :, None, None].float() * freqs             # [..., S, 1, hd/2]
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
