"""Hand-written CUDA kernels (``csrc/``), their plain PyTorch versions
(``ref.py``) and the engine-facing dispatch (``ops.py``)."""
