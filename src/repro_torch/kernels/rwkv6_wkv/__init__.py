"""RWKV-6 WKV chunked scan: CUDA kernel, its binding and plain versions."""
