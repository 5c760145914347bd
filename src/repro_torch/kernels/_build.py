"""Build the CUDA C++ kernels in ``csrc/`` and load them with ctypes.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, at first use, into
``build/repro_torch_kernels/`` at the root of the checkout.  A library's
file name carries a hash of every source in ``csrc/``, so an edit rebuilds
and a stale library is never loaded.  All sources compile at once, one
``nvcc`` process each.  A failed build raises with nvcc's stderr.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
SOURCES = ("flash_attention", "flash_decode", "dude_update")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: dict[str, ctypes.CDLL] = {}
build_log: dict[str, str] = {}      # ptxas report (registers, spills) per source


def _nvcc() -> str:
    return str(Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc")


def _source_hash() -> str:
    h = hashlib.sha256()
    for f in sorted(CSRC.iterdir()):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def _lib_path(name: str) -> Path:
    return BUILD_DIR / f"{name}-{_source_hash()}.so"


def build(names=SOURCES) -> float:
    """Compile every named source whose library is missing, in parallel.
    Returns the wall seconds spent; raises with nvcc's stderr on failure."""
    t0 = time.perf_counter()
    todo = [n for n in names if not _lib_path(n).exists()]
    if not todo:
        return 0.0
    nvcc = _nvcc()
    if not Path(nvcc).is_file():
        raise RuntimeError(f"nvcc not found at {nvcc}; set CUDA_HOME to the CUDA "
                           f"toolkit to build the kernels")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for n in todo:
        tmp = _lib_path(n).with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.PIPE, text=True))
    errors = []
    for n, (tmp, p) in procs.items():
        out, err = p.communicate()
        build_log[n] = out + err
        if p.returncode != 0:
            tmp.unlink(missing_ok=True)
            errors.append(f"nvcc failed on {n}.cu (exit {p.returncode}):\n{err}")
        else:
            os.replace(tmp, _lib_path(n))   # atomic: a reader sees all or none
    if errors:
        raise RuntimeError("\n".join(errors))
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    if name not in _libs:
        build((name,))
        lib = ctypes.CDLL(str(_lib_path(name)))
        lib.repro_error_string.argtypes = [ctypes.c_int]
        lib.repro_error_string.restype = ctypes.c_char_p
        _libs[name] = lib
    return _libs[name]


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if code != 0:
        msg = lib.repro_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code}: {msg}")
