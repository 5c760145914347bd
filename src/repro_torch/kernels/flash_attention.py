"""Launcher of the CUDA flash-attention kernel (``csrc/flash_attention.cu``),
the port of ``repro/kernels/flash_attention.py::flash_attention_pallas``.

``launch`` checks device, dtype, shape and contiguity, allocates the
output, and launches on the current stream.  It raises where the kernel
does not take its inputs or the launch fails; there is no fallback.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from . import _build

HEAD_DIMS = (16, 32, 64, 128)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.cache
def _lib():
    lib = _build.load("flash_attention")
    lib.flash_attention_fwd.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                        _I, _I, _I, _P]
    lib.flash_attention_fwd.restype = _I
    return lib


def check_cuda_inputs(name: str, *tensors: torch.Tensor) -> None:
    """The kernels take contiguous tensors of one supported dtype on the
    current CUDA device."""
    t0 = tensors[0]
    if t0.device.type != "cuda" or t0.device.index != torch.cuda.current_device():
        raise ValueError(f"{name}: tensors must lie on the current CUDA device, "
                         f"got {t0.device}")
    for t in tensors:
        if t.device != t0.device or t.dtype != t0.dtype:
            raise ValueError(f"{name}: all inputs need one device and dtype")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
    if t0.dtype not in DTYPES:
        raise ValueError(f"{name}: dtype {t0.dtype} not in {list(DTYPES)}")
    if t0.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"{name}: head_dim {t0.shape[-1]} not in {HEAD_DIMS}")


def launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
           causal: bool, window: Optional[int]) -> torch.Tensor:
    """q [B, Sq, H, hd], k/v [B, Sk, K, hd] on CUDA -> out [B, Sq, H, hd]."""
    check_cuda_inputs("flash_attention", q, k, v)
    B, Sq, H, hd = q.shape
    Sk, K = k.shape[1], k.shape[2]
    if k.shape != (B, Sk, K, hd) or v.shape != k.shape or H % K:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not form a GQA problem")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window={window} < 1")
    out = torch.empty_like(q)
    lib = _lib()
    code = lib.flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), DTYPES[q.dtype],
        B, Sq, Sk, H, K, hd, int(causal), window or 0,
        torch.cuda.current_stream().cuda_stream)
    _build.check(lib, code, "flash_attention")
    return out
