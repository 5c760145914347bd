"""Launcher of the fused DuDe round kernel (``csrc/dude_update.cu``), the
port of ``repro/kernels/dude_update.py::dude_round_apply_pallas`` (K1).

``launch`` checks devices, dtypes, shapes and contiguity, and launches the
kernel on the current stream.  The kernel writes ``g_workers``,
``inflight``, ``g_bar``, ``w`` and the slots in place.  The masks
``cm``/``sm`` and AdamW's bias corrections are device tensors passed by
pointer and the hyperparameters are floats passed by value, so a launch
needs no host sync.  It raises where the kernel does not take its inputs
or the launch fails; there is no fallback.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from .flash_attention import DTYPES

SLOT_STREAMS = {"sgd": 0, "momentum": 1, "adamw": 2}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


@functools.cache
def _lib():
    lib = _build.load("dude_update")
    lib.dude_round_apply.argtypes = [_P] * 10 + [_I, _I, _I, _I, ctypes.c_longlong] \
        + [_F] * 8 + [_P]
    lib.dude_round_apply.restype = _I
    return lib


def _kind_code(kind: str, hp: dict) -> int:
    if kind == "sgd":
        return 0
    if kind == "momentum":
        return 2 if hp["nesterov"] else 1
    if kind == "adamw":
        return 3
    raise ValueError(f"dude_round_apply: unknown optimizer kind {kind!r}")


def launch(cm: torch.Tensor, sm: torch.Tensor, fresh: torch.Tensor,
           g_workers: torch.Tensor, inflight: torch.Tensor, g_bar: torch.Tensor,
           w: torch.Tensor, slots: tuple, bias_corr, *, kind: str, hp: dict) -> None:
    """Fused round + optimizer step on CUDA tensors, in place."""
    n, P = fresh.shape
    dev = fresh.device
    if dev.type != "cuda" or dev.index != torch.cuda.current_device():
        raise ValueError(f"dude_round_apply: tensors must lie on the current CUDA "
                         f"device, got {dev}")
    vecs = (g_bar, w) + tuple(slots) + ((bias_corr,) if bias_corr is not None else ())
    for t in (cm, sm, g_workers, inflight) + vecs:
        if t.device != dev:
            raise ValueError("dude_round_apply: all tensors need one device")
    for t in (fresh, g_workers, inflight) + vecs:
        if not t.is_contiguous():
            raise ValueError("dude_round_apply: tensors must be contiguous")
    if fresh.dtype not in DTYPES or g_workers.dtype not in DTYPES \
            or inflight.dtype != g_workers.dtype:
        raise ValueError(f"dude_round_apply: fresh {fresh.dtype}, buffers "
                         f"{g_workers.dtype}/{inflight.dtype} not f32/bf16 pairs")
    if g_workers.shape != (n, P) or inflight.shape != (n, P) \
            or cm.shape != (n,) or sm.shape != (n,):
        raise ValueError(f"dude_round_apply: slabs {tuple(g_workers.shape)}/"
                         f"{tuple(inflight.shape)}, masks {tuple(cm.shape)}/"
                         f"{tuple(sm.shape)} do not match fresh {tuple(fresh.shape)}")
    if any(t.shape != (P,) or t.dtype != torch.float32 for t in (g_bar, w) + tuple(slots)):
        raise ValueError("dude_round_apply: g_bar, w and slots must be [P] f32")
    if len(slots) != SLOT_STREAMS[kind] or (bias_corr is not None) != (kind == "adamw"):
        raise ValueError(f"dude_round_apply: kind {kind!r} takes "
                         f"{SLOT_STREAMS[kind]} slots and bias corrections only for adamw")
    if g_workers.data_ptr() == inflight.data_ptr():
        raise ValueError("dude_round_apply: g_workers and inflight must not alias")
    cm32 = cm.to(torch.float32).contiguous()
    sm8 = sm.to(torch.uint8).contiguous()
    bc = bias_corr.to(torch.float32).contiguous() if bias_corr is not None else None
    m = slots[0] if slots else None
    v = slots[1] if len(slots) > 1 else None
    # 1 - b is formed in double on the host and then rounded to f32, as the
    # reference forms it from Python floats
    lib = _lib()
    code = lib.dude_round_apply(
        fresh.data_ptr(), g_workers.data_ptr(), inflight.data_ptr(), g_bar.data_ptr(),
        w.data_ptr(), m.data_ptr() if m is not None else None,
        v.data_ptr() if v is not None else None, cm32.data_ptr(), sm8.data_ptr(),
        bc.data_ptr() if bc is not None else None,
        DTYPES[fresh.dtype], DTYPES[g_workers.dtype], _kind_code(kind, hp), n, P,
        hp["lr"], hp.get("beta", 0.0), hp.get("b1", 0.0), 1 - hp.get("b1", 0.0),
        hp.get("b2", 0.0), 1 - hp.get("b2", 0.0), hp.get("eps", 0.0),
        hp.get("weight_decay", 0.0), torch.cuda.current_stream().cuda_stream)
    _build.check(lib, code, "dude_round_apply")
