"""Fused early-binding event loop (E/{H,LL,LOC,R}/PS): CUDA kernel, its
binding and plain version."""
