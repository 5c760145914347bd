"""The port's kernel wrappers against the reference's Pallas kernels.

On the CPU the port's ``ops.flash_attention`` / ``ops.flash_decode`` compute
their plain versions; the reference runs its Pallas kernels K2 and K5 in
interpret mode, as ``tests/test_kernels.py`` does.  Both get the same numpy
inputs.  Tolerances: 1e-5 in f32, 3e-2 in bf16 (the reference's own).
The CUDA kernels themselves are held against the plain versions on the card
by ``chip_smoke.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402

DTYPES = {"f32": (torch.float32, jnp.float32, 1e-5),
          "bf16": (torch.bfloat16, jnp.bfloat16, 3e-2)}


def _inputs(seed, shapes, dtype):
    """The same values for both packages: f32 numpy, rounded identically
    (round to nearest even) when cast to bf16 on each side."""
    tdt, jdt, _ = DTYPES[dtype]
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    return ([torch.from_numpy(a).to(tdt) for a in arrs],
            [jnp.asarray(a, jdt) for a in arrs])


def _close(port, jax_out, tol):
    np.testing.assert_allclose(port.float().numpy(),
                               np.asarray(jax_out, np.float32), atol=tol, rtol=0)


@pytest.mark.parametrize("B,S,H,K,hd,blk,window", [
    (1, 128, 4, 4, 32, 64, None),    # MHA, even blocks
    (2, 200, 4, 2, 32, 64, None),    # GQA, ragged tail
    (1, 96, 8, 1, 16, 32, None),     # MQA
    (1, 160, 4, 2, 32, 32, 16),      # sliding windows
    (1, 160, 4, 2, 32, 32, 48),
])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_flash_attention_matches_reference_kernel(B, S, H, K, hd, blk, window, dtype):
    (q, k, v), (jq, jk, jv) = _inputs(S * H + (window or 0),
                                      [(B, S, H, hd), (B, S, K, hd), (B, S, K, hd)], dtype)
    out = ops.flash_attention(q, k, v, causal=True, window=window)
    jout = jops.flash_attention(jq, jk, jv, window=window, blk_q=blk, blk_k=blk,
                                interpret=True)
    assert out.shape == q.shape and out.dtype == q.dtype
    _close(out, jout, DTYPES[dtype][2])


@pytest.mark.parametrize("B,S,H,K,hd,blk,length,window", [
    (2, 256, 4, 2, 32, 64, 200, None),
    (1, 128, 8, 8, 16, 32, 128, None),
    (1, 512, 8, 2, 64, 128, 3, None),
    (2, 256, 4, 2, 32, 64, 200, 48),     # window inside the cache
    (1, 512, 8, 2, 64, 128, 300, 100),
    (1, 128, 8, 8, 16, 32, 20, 64),      # window longer than the length
])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_flash_decode_matches_reference_kernel(B, S, H, K, hd, blk, length, window, dtype):
    (q, kc, vc), (jq, jkc, jvc) = _inputs(
        S + length, [(B, 1, H, hd), (B, S, K, hd), (B, S, K, hd)], dtype)
    out = ops.flash_decode(q, kc, vc, length, window=window)
    jout = jops.flash_decode(jq, jkc, jvc, length, window=window, blk_s=blk,
                             interpret=True)
    assert out.shape == q.shape and out.dtype == q.dtype
    _close(out, jout, DTYPES[dtype][2])


def test_plain_versions_agree_with_each_other():
    """Decode at position length-1 is the last row of causal attention over
    the first ``length`` positions, with and without a window."""
    (q, k, v), _ = _inputs(7, [(2, 40, 6, 16), (2, 40, 3, 16), (2, 40, 3, 16)], "f32")
    for window in (None, 9):
        full = ref.flash_attention_ref(q, k, v, window=window)
        for length in (1, 17, 40):
            dec = ref.flash_decode_ref(q[:, length - 1:length], k, v, length,
                                       window=window)
            torch.testing.assert_close(dec, full[:, length - 1:length],
                                       atol=1e-6, rtol=0)


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    ops.reset_launch_counts()
    (q, k, v), _ = _inputs(1, [(1, 8, 2, 16), (1, 8, 1, 16), (1, 8, 1, 16)], "f32")
    ops.flash_attention(q, k, v)
    ops.flash_decode(q[:, :1], k, v, 5)
    assert ops.flash_attention.launches == 0 and ops.flash_decode.launches == 0


@pytest.mark.parametrize("call", ["attention", "decode"])
def test_other_devices_raise_rather_than_fall_back(call):
    q = torch.zeros((1, 1, 2, 16), device="meta")
    kv = torch.zeros((1, 4, 1, 16), device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        if call == "attention":
            ops.flash_attention(q, kv, kv)
        else:
            ops.flash_decode(q, kv, kv, 2)


def test_build_without_nvcc_raises(tmp_path, monkeypatch):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()
    assert not (tmp_path / "build").exists()
