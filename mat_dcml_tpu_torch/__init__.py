"""PyTorch / CUDA port of ``mat_dcml_tpu`` for an NVIDIA H100.

The JAX package stays the reference; this package imports nothing of it,
nor JAX.  Each kernel that the JAX package wrote in Pallas for the TPU has a
hand-written CUDA counterpart under ``csrc/``.
"""
