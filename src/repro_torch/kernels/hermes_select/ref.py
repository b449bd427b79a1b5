"""Plain torch version of the batched Hermes dispatch.

The same function as the CUDA kernel (``csrc/hermes_select.cu``) and as
the reference's Pallas kernel (``repro/kernels/hermes_select``): a Python
loop over the ``N`` arrivals, each one a vectorised score and
first-index argmax over ``[R, W]``.  The CPU tests and the engine's
``torch`` backend run it; the chip check holds the kernel against it.
"""
from __future__ import annotations

import torch

_BIG = 1 << 30


def hermes_select_ref(active, warm_cols, *, cores: int, slots: int):
    """active: ``[R, W]`` (or ``[W]``) int; warm_cols: ``[R, N, W]`` (or
    ``[N, W]``) warm-executor counts of each arrival's function.

    Returns ``(choices [R, N] i32 — worker or -1, active_out [R, W] i32)``
    (without the ``R`` axis when the inputs had none).
    """
    single = active.dim() == 1
    if single:
        active, warm_cols = active[None], warm_cols[None]
    act = active.to(torch.int32)
    R, N, W = warm_cols.shape
    lanes = torch.arange(W, device=act.device)
    choices = torch.empty((R, N), dtype=torch.int32, device=act.device)
    for i in range(N):
        warm = (warm_cols[:, i] > 0).to(torch.int32)
        has_slot = act < slots
        has_core = act < cores
        cls = torch.where(act > 0, 2 + warm, warm)
        lo = torch.where(has_core, cls * (slots + 1) + act, -_BIG)
        hi = torch.where(has_slot, -(act * 2 - warm), -_BIG)
        score = torch.where(has_core.any(dim=1, keepdim=True), lo, hi)
        w = score.argmax(dim=1)                    # first index of the max
        ok = has_slot.any(dim=1)
        choices[:, i] = torch.where(ok, w, -1)
        act = act + (ok[:, None] & (lanes == w[:, None])).to(torch.int32)
    if single:
        return choices[0], act[0]
    return choices, act
