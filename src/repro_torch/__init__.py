"""PyTorch port of the ``repro`` package, for NVIDIA Hopper (H100).

It mirrors ``repro``'s layout (``configs/``, ``core/``, ``optim/``,
``data/``, ``models/``, ``kernels/``, ``launch/``, ``api/``) and covers two
paths so far, on dense transformer LMs: serving
(``ServeSession.create -> prefill -> decode/generate``, with prefill
attention and flash-decode as hand-written CUDA C++ kernels) and the
semi-async DuDe training round (``Trainer.create -> step``, with the fused
server round as a hand-written CUDA C++ kernel); the kernels are in
``csrc/``.  It imports neither ``jax`` nor ``repro``; the JAX package is
the reference its tests hold it against.
"""
