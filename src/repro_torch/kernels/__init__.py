"""Width-generic SZx kernels: hand-written CUDA for Hopper (``csrc/``) with
their plain PyTorch versions (``ref.py``), dispatched by device (``ops.py``)."""
