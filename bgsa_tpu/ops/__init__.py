"""Alignment kernels: XLA (portable) and Pallas (GPU, Triton route) backends."""
