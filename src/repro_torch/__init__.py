"""PyTorch port of the ``repro`` package, for NVIDIA Hopper (H100).

It mirrors ``repro``'s layout (``configs/``, ``models/``, ``kernels/``,
``launch/``, ``api/``) and covers the serving path so far:
``ServeSession.create -> prefill -> decode/generate`` on dense transformer
LMs, with prefill attention and flash-decode as hand-written CUDA C++
kernels (``csrc/``).  It imports neither ``jax`` nor ``repro``; the JAX
package is the reference its tests hold it against.
"""
