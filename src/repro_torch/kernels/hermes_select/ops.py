"""Hermes dispatch entry points: the kernel on the card, its plain
version for tensors on the CPU.

:func:`hermes_select_batch` is what the engine calls (warm columns
already gathered); :func:`hermes_select` keeps the reference's
``(active, warm [W, F], funcs [N])`` gather API, batched over an
optional leading ``R`` axis.
"""
from __future__ import annotations

import torch

from repro_torch.device import resolve_device

from . import kernel
from .ref import hermes_select_ref


def hermes_select_batch(active: torch.Tensor, warm_cols: torch.Tensor, *,
                        cores: int, slots: int):
    """``[R, W]``, ``[R, N, W]`` → ``(choices [R, N], active_out [R, W])``.

    CPU tensors take the plain version; CUDA tensors launch the kernel,
    which raises on anything it does not take.
    """
    if active.device.type == "cpu":
        return hermes_select_ref(active, warm_cols, cores=cores,
                                 slots=slots)
    return kernel.hermes_select_batch(active, warm_cols, cores=cores,
                                      slots=slots)


def hermes_select(active, warm, funcs, *, cores: int, slots: int,
                  device=None):
    """active ``[W]``; warm ``[W, F]``; funcs ``[N]`` arrival function ids
    (or the same with a leading ``R`` axis).  ``device=None`` is CUDA.

    Returns ``(choices [N] i32, active_out [W] i32)`` (with ``R`` if given).
    """
    dev = resolve_device(device)
    active = torch.as_tensor(active, device=dev).to(torch.int32)
    warm = torch.as_tensor(warm, device=dev).to(torch.int32)
    funcs = torch.as_tensor(funcs, device=dev).to(torch.int64)
    single = active.dim() == 1
    if single:
        active, warm, funcs = active[None], warm[None], funcs[None]
    R, W, _ = warm.shape
    N = funcs.shape[1]
    warm_cols = warm.transpose(1, 2).gather(
        1, funcs[:, :, None].expand(R, N, W)).contiguous()   # [R, N, W]
    choices, act = hermes_select_batch(active.contiguous(), warm_cols,
                                       cores=cores, slots=slots)
    if single:
        return choices[0], act[0]
    return choices, act
