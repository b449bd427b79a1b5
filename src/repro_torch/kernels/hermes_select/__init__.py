"""Hermes batched dispatch: CUDA kernel, its binding and plain version."""
