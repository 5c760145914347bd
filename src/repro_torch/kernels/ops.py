"""Public wrappers of the port's kernels.

For tensors on a CUDA device each wrapper launches its hand-written kernel
or raises; for tensors on the CPU it computes the kernel's plain PyTorch
version (``ref.py``).  The choice follows only the device of the tensors it
is given.  Each wrapper counts its kernel launches in ``<wrapper>.launches``
(a plain int), so a run can show that its main path went through the
kernels.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import dude_update as _du
from . import flash_attention as _fa
from . import flash_decode as _fd
from . import ref


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None) -> torch.Tensor:
    """Causal (optionally sliding-window) GQA attention of q [B,Sq,H,hd] over
    k/v [B,Sk,K,hd]; the port of K2 ``flash_attention_pallas``."""
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    out = _fa.launch(q, k, v, causal=causal, window=window)
    flash_attention.launches += 1
    return out


def flash_decode(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                 length: int, *, window: Optional[int] = None) -> torch.Tensor:
    """One query token q [B,1,H,hd] against the first ``length`` positions of
    a KV cache [B,S,K,hd]; the port of K5 ``flash_decode_pallas``."""
    if q.device.type == "cpu":
        return ref.flash_decode_ref(q, k_cache, v_cache, length, window=window)
    out = _fd.launch(q, k_cache, v_cache, length, window=window)
    flash_decode.launches += 1
    return out


def dude_round_apply(cm: torch.Tensor, sm: torch.Tensor, fresh: torch.Tensor,
                     g_workers: torch.Tensor, inflight: torch.Tensor, g_bar: torch.Tensor,
                     w: torch.Tensor, slots: tuple = (),
                     bias_corr: Optional[torch.Tensor] = None, *, kind: str = "sgd",
                     hp: tuple = (("lr", 0.0),)):
    """One DuDe round fused with the optimizer step on flat slabs, in
    place: fresh [n,P] f32/bf16, g_workers/inflight [n,P] f32/bf16, g_bar,
    w and slots [P] f32, masks [n], AdamW's bias corrections [2].  Returns
    ``(g_workers, inflight, g_bar, w, slots)``, the inputs updated; the port
    of K1 ``dude_round_apply_pallas``."""
    hp = dict(hp)
    if fresh.device.type == "cpu":
        return ref.dude_round_apply_ref(cm, sm, fresh, g_workers, inflight, g_bar, w,
                                        slots, bias_corr, kind=kind, hp=hp)
    _du.launch(cm, sm, fresh, g_workers, inflight, g_bar, w, tuple(slots), bias_corr,
               kind=kind, hp=hp)
    dude_round_apply.launches += 1
    return g_workers, inflight, g_bar, w, tuple(slots)


flash_attention.launches = 0
flash_decode.launches = 0
dude_round_apply.launches = 0


def reset_launch_counts() -> None:
    flash_attention.launches = 0
    flash_decode.launches = 0
    dude_round_apply.launches = 0
