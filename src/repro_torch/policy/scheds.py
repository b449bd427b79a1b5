"""Intra-worker schedulers: rate assignment, in torch and in numpy.

Counterpart of ``repro/policy/scheds.py``.  Each torch factory takes the
worker's core count and the device and returns ``rates(task_idx,
remaining) -> f64`` over tensors of shape ``[..., W, S]`` (``task_idx <
0`` marks an empty slot), so one call serves all ``R`` replications of
the batched engine.  Each numpy factory (``*_np``, the reference's ``np``
backend: the oracle's and the serving platform's) takes the core count
and returns ``rates(remaining, seqs) -> list[float]`` over one worker's
parallel task lists (``seqs`` are arrival sequence numbers), with the
reference's float operations in its order.

* ``PS``   — every active task gets ``min(1, C/n)`` cores.
* ``FCFS`` — the ``C`` earliest arrivals (lowest ``task_idx``) run at 1.
* ``SRPT`` — the ``C`` tasks with least remaining work run at 1; ties
  break by slot order (stable rank) in torch, by arrival sequence in
  numpy, as in the reference.
"""
from __future__ import annotations

import torch

_F64 = torch.float64


def _rank_last(key: torch.Tensor) -> torch.Tensor:
    """Stable rank of each element along the last axis (0 = smallest)."""
    order = torch.argsort(key, dim=-1, stable=True)
    pos = torch.arange(key.shape[-1], device=key.device).expand_as(order)
    return torch.empty_like(order).scatter_(-1, order, pos)


def ps(cores: int, device):
    # an f64 tensor numerator: torch evaluates ``python_number / tensor``
    # as ``reciprocal(tensor) * number``, which rounds differently from
    # the reference's IEEE division (12/17 is one ulp off), and
    # ``int_tensor / int`` is float32
    c = torch.tensor(float(cores), dtype=_F64, device=device)

    def rates(task_idx, remaining):
        active = task_idx >= 0
        n = active.sum(dim=-1, keepdim=True)
        r = torch.clamp(c / n.clamp(min=1).to(_F64), max=1.0)
        return torch.where(active, r, 0.0)
    return rates


def fcfs(cores: int, device):
    def rates(task_idx, remaining):
        active = task_idx >= 0
        key = torch.where(active, task_idx, 1 << 30)
        return (active & (_rank_last(key) < cores)).to(_F64)
    return rates


def srpt(cores: int, device):
    def rates(task_idx, remaining):
        active = task_idx >= 0
        key = torch.where(active, remaining, torch.inf)
        return (active & (_rank_last(key) < cores)).to(_F64)
    return rates


def ps_np(cores: int):
    def rates(remaining, seqs):
        n = len(remaining)
        r = min(1.0, cores / n) if n else 0.0
        return [r] * n
    return rates


def fcfs_np(cores: int):
    def rates(remaining, seqs):
        n = len(seqs)
        order = sorted(range(n), key=lambda i: seqs[i])
        out = [0.0] * n
        for k, i in enumerate(order):
            out[i] = 1.0 if k < cores else 0.0
        return out
    return rates


def srpt_np(cores: int):
    def rates(remaining, seqs):
        n = len(seqs)
        order = sorted(range(n), key=lambda i: (remaining[i], seqs[i]))
        out = [0.0] * n
        for k, i in enumerate(order):
            out[i] = 1.0 if k < cores else 0.0
        return out
    return rates
