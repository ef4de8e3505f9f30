"""repro_torch -- the SZx codec ported to PyTorch and CUDA for the NVIDIA H100.

The JAX package ``repro`` is the reference; this package imports nothing of
it.  Start at :mod:`repro_torch.api`.
"""
