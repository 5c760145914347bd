"""Hand-written CUDA kernels of the port (``csrc/``), their ctypes
launchers, their plain PyTorch versions (``ref.py``) and the public
wrappers that choose between them by device (``ops.py``)."""
