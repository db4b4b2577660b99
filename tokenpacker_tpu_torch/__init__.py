"""TokenPacker serving path in PyTorch with hand-written CUDA kernels.

The counterpart of `tokenpacker_tpu` (JAX on TPU) for one NVIDIA Hopper
card. The layout mirrors the JAX package so each module's reference is
easy to find; the JAX package stays the reference the port is tested
against. Nothing here imports JAX or the JAX package.
"""
