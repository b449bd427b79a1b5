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

The policy zoo (the reference's registry extensions):

* ``JSQ2`` — two choices from one uniform, the shorter queue; the global
  least-loaded worker when the chosen one is slot-full.
* ``RR``   — LOC's ring walk from the home ``idx % W``.
* ``HIKU``, ``DD``, ``SWARM`` carry state: each has ``init_state(R, W, F,
  device)`` (a dict of ``[R, …]`` tensors) and a factory returning the
  pair::

      select(state, active, warm_col, func, func_home, u, idx)
          -> (worker [R] i32, state)
      on_complete(state, w [R], func [R], service [R] f64,
                  n_active_after [R]) -> state

  A replication whose arrival is rejected keeps its state.  The float
  updates run in the reference's order of operations, so the state is
  bit-equal to the reference's ``np`` and ``jax`` backends.
  ``HIKU`` pops the oldest idle worker of a ready-ring (least loaded
  when the ring is empty); ``DD`` joins the worker with the least
  expected work from per-function EMAs of the service; ``SWARM`` learns
  per-function scales and per-worker slowness as median trackers.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.hermes_select import ops as hermes_ops
from repro_torch.kernels.hermes_select.ref import hermes_select_ref

_BIG = 1 << 30
_F64, _I32, _I64 = torch.float64, torch.int32, torch.int64

# DD's EMA step (a power of two, so ``α·d`` is exact) and prior, s
DD_ALPHA = 0.25
DD_PRIOR_S = 1.0
# SWARM's multiplicative sign-EMA steps: est ×= (1±α) toward the
# median, inv ×= (1±γ) while a worker burns in (its first SWARM_WARM_N
# completions), then (1±γ_cold)
SWARM_ALPHA = 0.25
SWARM_GAMMA = 0.125
SWARM_GAMMA_COLD = 0.0078125
SWARM_WARM_N = 128
SWARM_PRIOR_S = 1.0
_SW_EST_UP = 1.0 + SWARM_ALPHA
_SW_EST_DN = 1.0 / (1.0 + SWARM_ALPHA)
_SW_HOT_UP = 1.0 + SWARM_GAMMA
_SW_HOT_DN = 1.0 / (1.0 + SWARM_GAMMA)
_SW_COLD_UP = 1.0 + SWARM_GAMMA_COLD
_SW_COLD_DN = 1.0 / (1.0 + SWARM_GAMMA_COLD)


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


def jsq2(cores: int, slots: int, n_workers: int, device):
    W = n_workers

    def select(active, warm_col, func, func_home, u, idx):
        has_slot = active < slots
        x = u * W                                              # f64
        a = x.to(_I64).clamp(max=W - 1)
        b = ((x - x.floor()) * W).to(_I64).clamp(max=W - 1)
        key = torch.where(has_slot, active, _BIG)
        pick = torch.where(key.gather(1, b[:, None])[:, 0]
                           < key.gather(1, a[:, None])[:, 0], b, a)
        w = torch.where(has_slot.gather(1, pick[:, None])[:, 0], pick,
                        key.argmin(dim=1))
        return _guard(w, has_slot)
    return select


def round_robin(cores: int, slots: int, n_workers: int, device):
    offsets = torch.arange(n_workers, dtype=_I64, device=device)

    def select(active, warm_col, func, func_home, u, idx):
        has_slot = active < slots
        ring = ((int(idx) % n_workers + offsets) % n_workers).expand_as(
            active)
        first = has_slot.gather(1, ring).to(torch.int32).argmax(
            dim=1, keepdim=True)
        return _guard(ring.gather(1, first)[:, 0], has_slot)
    return select


def _rows(x: torch.Tensor) -> torch.Tensor:
    return torch.arange(x.shape[0], device=x.device)


def hiku_init(R: int, W: int, F: int, device) -> dict:
    """Every worker starts advertised (all are idle at t = 0)."""
    return {"ring": torch.arange(W, dtype=_I32, device=device).repeat(R, 1),
            "in_ring": torch.ones((R, W), dtype=_I32, device=device),
            "head": torch.zeros(R, dtype=_I32, device=device),
            "tail": torch.full((R,), W, dtype=_I32, device=device)}


def hiku(cores: int, slots: int, n_workers: int, device):
    W = n_workers

    def select(state, active, warm_col, func, func_home, u, idx):
        rows = _rows(active)
        has_slot = active < slots
        head, ring, in_ring = state["head"], state["ring"], state["in_ring"]
        # a pop takes the ring's head even when that worker is slot-full
        # (then least loaded places the arrival); a rejection pops nothing
        pop = (state["tail"] > head) & has_slot.any(dim=1)
        cand = ring[rows, (head % W).to(_I64)].to(_I64)
        ll_w = torch.where(has_slot, active, _BIG).argmin(dim=1)
        w = torch.where(pop & has_slot[rows, cand], cand, ll_w)
        in_ring = in_ring.index_put(
            (rows, cand), torch.where(pop, 0, in_ring[rows, cand]))
        return _guard(w, has_slot), dict(state, head=head + pop.to(_I32),
                                         in_ring=in_ring)

    def on_complete(state, w, func, service, n_active_after):
        rows = _rows(w)
        ring, in_ring, tail = state["ring"], state["in_ring"], state["tail"]
        push = (n_active_after == 0) & (in_ring[rows, w] == 0)
        pos = (tail % W).to(_I64)
        ring = ring.index_put(
            (rows, pos), torch.where(push, w.to(_I32), ring[rows, pos]))
        in_ring = in_ring.index_put(
            (rows, w), torch.where(push, 1, in_ring[rows, w]))
        return dict(state, ring=ring, in_ring=in_ring,
                    tail=tail + push.to(_I32))

    return select, on_complete


def dd_init(R: int, W: int, F: int, device) -> dict:
    return {"est": torch.full((R, F), DD_PRIOR_S, dtype=_F64, device=device),
            "ew": torch.zeros((R, W), dtype=_F64, device=device)}


def data_driven(cores: int, slots: int, n_workers: int, device):
    def select(state, active, warm_col, func, func_home, u, idx):
        rows = _rows(active)
        has_slot = active < slots
        ew = state["ew"]
        w = torch.where(has_slot, ew, torch.inf).argmin(dim=1)
        # the worker is charged the function's estimate only if placed
        placed = has_slot.any(dim=1)
        ew_w = ew[rows, w]
        ew = ew.index_put((rows, w), torch.where(
            placed, ew_w + state["est"][rows, func], ew_w))
        return _guard(w, has_slot), dict(state, ew=ew)

    def on_complete(state, w, func, service, n_active_after):
        rows = _rows(w)
        est_f = state["est"][rows, func]          # read before the update
        ew = state["ew"].index_put(
            (rows, w), (state["ew"][rows, w] - est_f).clamp(min=0.0))
        est = state["est"].index_put(
            (rows, func), est_f + DD_ALPHA * (service - est_f))
        return dict(state, est=est, ew=ew)

    return select, on_complete


def swarm_init(R: int, W: int, F: int, device) -> dict:
    return {"est": torch.full((R, F), SWARM_PRIOR_S, dtype=_F64,
                              device=device),
            "inv": torch.ones((R, W), dtype=_F64, device=device),
            "cnt": torch.zeros((R, W), dtype=_I64, device=device)}


def swarm(cores: int, slots: int, n_workers: int, device):
    def select(state, active, warm_col, func, func_home, u, idx):
        has_slot = active < slots
        inv = state["inv"]
        # below core saturation the fastest free worker; at saturation
        # the least queue depth × slowness.  ``active + 1.0`` on an int
        # tensor would be f32: the cast comes first
        key = torch.where(active + 1 <= cores, inv,
                          (active.to(_F64) + 1.0) * inv)
        w = torch.where(has_slot, key, torch.inf).argmin(dim=1)
        return _guard(w, has_slot), state

    def on_complete(state, w, func, service, n_active_after):
        rows = _rows(w)
        est, inv, cnt = state["est"], state["inv"], state["cnt"]
        est_f = est[rows, func]
        sample = service / est_f          # f64 / f64: IEEE division
        # a step picked by a comparison, times the value: with python
        # scalars in both arms torch.where would round the steps to f32
        est_f_new = torch.where(service > est_f, est_f * _SW_EST_UP,
                                est_f * _SW_EST_DN)
        hot = cnt[rows, w] < SWARM_WARM_N
        inv_w = inv[rows, w]
        up = sample > inv_w
        inv_w_new = torch.where(
            up, torch.where(hot, inv_w * _SW_HOT_UP, inv_w * _SW_COLD_UP),
            torch.where(hot, inv_w * _SW_HOT_DN, inv_w * _SW_COLD_DN))
        return dict(state, est=est.index_put((rows, func), est_f_new),
                    inv=inv.index_put((rows, w), inv_w_new),
                    cnt=cnt.index_put((rows, w), cnt[rows, w] + 1))

    return select, on_complete
