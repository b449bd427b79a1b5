"""ctypes binding of the ``hermes_select`` CUDA kernel.

The kernel (``src/repro_torch/csrc/hermes_select.cu``) replaces the
Pallas TPU kernel ``repro/kernels/hermes_select/kernel.py``
(``hermes_select_batch``).  :func:`hermes_select_batch` checks its
inputs, allocates the outputs, launches on PyTorch's current stream and
raises if the launch was refused.  ``hermes_select_batch.launches``
counts its launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

#: the kernel keeps one replication's loads in 48 KB of shared memory
MAX_WORKERS = 12288


@functools.cache
def _launcher():
    fn = _build.load("hermes_select").hermes_select_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(name: str, x: torch.Tensor, ndim: int) -> None:
    if not x.is_cuda:
        raise ValueError(f"hermes_select: {name} must be a CUDA tensor, "
                         f"got one on {x.device}")
    if x.dtype != torch.int32:
        raise ValueError(f"hermes_select: {name} must be int32, got "
                         f"{x.dtype}")
    if x.dim() != ndim or not x.is_contiguous():
        raise ValueError(f"hermes_select: {name} must be a contiguous "
                         f"{ndim}-D tensor, got shape {tuple(x.shape)}")


def hermes_select_batch(active: torch.Tensor, warm_cols: torch.Tensor, *,
                        cores: int, slots: int):
    """active ``[R, W]`` i32, warm_cols ``[R, N, W]`` i32, both contiguous
    on one CUDA device → ``(choices [R, N] i32, active_out [R, W] i32)``."""
    _check("active", active, 2)
    _check("warm_cols", warm_cols, 3)
    R, W = active.shape
    N = warm_cols.shape[1]
    if warm_cols.shape != (R, N, W) or warm_cols.device != active.device:
        raise ValueError(
            f"hermes_select: warm_cols must be [R={R}, N, W={W}] on "
            f"{active.device}, got {tuple(warm_cols.shape)} on "
            f"{warm_cols.device}")
    if not 1 <= W <= MAX_WORKERS or R < 1:
        raise ValueError(f"hermes_select: needs R >= 1 and 1 <= W <= "
                         f"{MAX_WORKERS}, got R={R}, W={W}")
    choices = torch.empty((R, N), dtype=torch.int32, device=active.device)
    active_out = torch.empty_like(active)
    with torch.cuda.device(active.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _launcher()(active.data_ptr(), warm_cols.data_ptr(),
                          choices.data_ptr(), active_out.data_ptr(),
                          R, N, W, int(cores), int(slots), stream)
    if err != 0:
        raise RuntimeError(f"hermes_select: kernel launch failed with "
                           f"CUDA error {err}")
    hermes_select_batch.launches += 1
    return choices, active_out


hermes_select_batch.launches = 0
