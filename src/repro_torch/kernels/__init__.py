"""Attention kernels of the port: a hand-written CUDA kernel per TPU
kernel on the serving path, each beside its plain PyTorch version."""
