"""Hand-written CUDA kernels (sources in ``repro_torch/csrc``), each with
a plain torch version beside it."""
