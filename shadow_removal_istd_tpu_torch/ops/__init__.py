"""Ops with hand-written CUDA kernels, each beside its plain version."""
