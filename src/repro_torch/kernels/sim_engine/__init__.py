"""Fused early-binding event loop (E/<B>/PS for the nine balancers):
CUDA kernel, its binding and plain version."""
