"""One-token decode attention: CUDA kernel, its binding and plain version."""
