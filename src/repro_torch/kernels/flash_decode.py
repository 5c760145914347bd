"""Launcher of the CUDA flash-decode kernels (``csrc/flash_decode.cu``), the
port of ``repro/kernels/flash_decode.py::flash_decode_pallas``.

``launch`` checks its inputs, allocates the output and the split-K partials
(f32 scratch), and launches the split and merge kernels on the current
stream.  ``length`` and ``window`` are Python ints, passed by value: no
device sync.  It raises where the kernel does not take its inputs or the
launch fails; there is no fallback.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from . import _build
from .flash_attention import DTYPES, check_cuda_inputs

_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.cache
def _lib():
    lib = _build.load("flash_decode")
    lib.flash_decode_fwd.argtypes = [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                     _I, _I, _I, _I, _I, _P]
    lib.flash_decode_fwd.restype = _I
    lib.flash_decode_chunk.argtypes = []
    lib.flash_decode_chunk.restype = _I
    return lib


def launch(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
           length: int, *, window: Optional[int]) -> torch.Tensor:
    """q [B, 1, H, hd], k/v_cache [B, S, K, hd] on CUDA -> out [B, 1, H, hd]."""
    check_cuda_inputs("flash_decode", q, k_cache, v_cache)
    B, one, H, hd = q.shape
    S, K = k_cache.shape[1], k_cache.shape[2]
    if (one != 1 or k_cache.shape != (B, S, K, hd) or v_cache.shape != k_cache.shape
            or H % K):
        raise ValueError(f"flash_decode: q {tuple(q.shape)}, cache "
                         f"{tuple(k_cache.shape)}/{tuple(v_cache.shape)} do not "
                         f"form a GQA decode problem")
    if not 1 <= length <= S:
        raise ValueError(f"flash_decode: length={length} outside [1, {S}]")
    if window is not None and window < 1:
        raise ValueError(f"flash_decode: window={window} < 1")
    lib = _lib()
    splits = -(-S // lib.flash_decode_chunk())
    out = torch.empty_like(q)
    m_part = torch.empty((B, H, splits), device=q.device, dtype=torch.float32)
    l_part = torch.empty_like(m_part)
    acc_part = torch.empty((B, H, splits, hd), device=q.device, dtype=torch.float32)
    code = lib.flash_decode_fwd(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), out.data_ptr(),
        m_part.data_ptr(), l_part.data_ptr(), acc_part.data_ptr(), DTYPES[q.dtype],
        B, S, H, K, hd, length, window or 0, splits,
        torch.cuda.current_stream().cuda_stream)
    _build.check(lib, code, "flash_decode")
    return out
