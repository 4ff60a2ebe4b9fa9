"""Kernels of the port: a hand-written CUDA kernel per TPU kernel of the
JAX package, each beside its plain PyTorch version."""
