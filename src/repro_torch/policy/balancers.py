"""Load balancers: batched worker selection (paper §3.1, §4.2).

Counterpart of the jax backends in ``repro/policy/balancers.py`` with the
replication axis written out.  Every factory takes
``(cores, slots, n_workers, device)`` and returns::

    select(active [R, W] i32, warm_col [R, W] i32, func [R] i64,
           func_home [R, F] i32, u [R] f64, idx) -> worker [R] i32

with ``-1`` where every worker of that replication is slot-full.  Ties
go to the lowest worker index, as in the reference.

* ``LOC`` — OpenWhisk sticky hashing: the first worker with a free slot
  on the ring starting at the function's home.
* ``R``   — uniform over workers with a free slot, from the pre-drawn ``u``.
* ``LL``  — least loaded among workers with a free slot.
* ``H``   — Hermes: packing while any worker has a free core, least
  loaded otherwise.  It runs the ``hermes_select`` kernel
  (:mod:`repro_torch.kernels.hermes_select`) or, on the ``torch``
  backend, the kernel's plain version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.hermes_select import ops as hermes_ops
from repro_torch.kernels.hermes_select.ref import hermes_select_ref

_BIG = 1 << 30


def _guard(w: torch.Tensor, has_slot: torch.Tensor) -> torch.Tensor:
    return torch.where(has_slot.any(dim=-1), w, -1).to(torch.int32)


def loc(cores: int, slots: int, n_workers: int, device):
    offsets = torch.arange(n_workers, dtype=torch.int32, device=device)

    def select(active, warm_col, func, func_home, u, idx):
        has_slot = active < slots
        home = func_home.gather(1, func[:, None])             # [R, 1]
        ring = ((home + offsets) % n_workers).long()            # [R, W]
        first = has_slot.gather(1, ring).to(torch.int32).argmax(
            dim=1, keepdim=True)
        return _guard(ring.gather(1, first)[:, 0], has_slot)
    return select


def random_pick(cores: int, slots: int, n_workers: int, device):
    def select(active, warm_col, func, func_home, u, idx):
        has_slot = active < slots
        k = has_slot.sum(dim=1)
        target = torch.minimum((u * k).to(torch.int32), k - 1)
        # index of the (target+1)-th free worker
        csum = torch.cumsum(has_slot.to(torch.int32), dim=1) - 1
        hit = has_slot & (csum == target[:, None])
        return _guard(hit.to(torch.int32).argmax(dim=1), has_slot)
    return select


def least_loaded(cores: int, slots: int, n_workers: int, device):
    def select(active, warm_col, func, func_home, u, idx):
        has_slot = active < slots
        key = torch.where(has_slot, active, _BIG)
        return _guard(key.argmin(dim=1), has_slot)
    return select


def _hybrid(dispatch, cores: int, slots: int):
    def select(active, warm_col, func, func_home, u, idx):
        # one arrival (N=1) per replication: completions are applied by
        # the engine between arrivals, so each decision sees fresh state
        choices, _ = dispatch(active, warm_col[:, None, :],
                              cores=cores, slots=slots)
        return choices[:, 0]
    return select


def hybrid(cores: int, slots: int, n_workers: int, device):
    """Hermes through the kernel's plain torch version (any device)."""
    return _hybrid(hermes_select_ref, cores, slots)


def hybrid_kernel(cores: int, slots: int, n_workers: int, device):
    """Hermes through ``hermes_select``: the CUDA kernel on the card."""
    return _hybrid(hermes_ops.hermes_select_batch, cores, slots)
