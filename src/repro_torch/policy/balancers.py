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

The numpy backends (``*_np``, the reference's ``np`` backend, which the
oracle :mod:`repro_torch.core.sim_ref` and the numpy compat shims run)
take ``(cores, slots)`` and return the reference's one-replication
contract::

    select(active [W], warm_col [W], func, func_home [F], u, idx) -> w

(``-1`` when every worker is slot-full, the first index on ties); the
carried-state ones return ``(select, on_complete)`` over a dict of numpy
arrays from ``*_init_np(W, F)``, with ``select(state, ...) -> (w,
state)``.  They make the reference's float and integer operations in its
order, so they equal its ``np`` backend bit for bit.
"""
from __future__ import annotations

import numpy as np
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


# --------------------------------------------------------------------------
# numpy backends: the reference's ``np`` selects, one replication each
# --------------------------------------------------------------------------

_INT_INF = np.int64(1 << 40)


def hermes_score_np(active: np.ndarray, warm_f: np.ndarray, cores: int,
                    slots: int) -> tuple[np.ndarray, bool]:
    """Hermes' score to maximise over the workers, and whether some worker
    has a free core (the packing mode); the kernels' oracle."""
    has_core = active < cores
    low_load = bool(has_core.any())
    warm = warm_f > 0
    if low_load:
        nonempty = active > 0
        cls = np.where(nonempty, 2 + warm.astype(np.int64),
                       warm.astype(np.int64))
        score = cls * (slots + 1) + active
        score = np.where(has_core, score, -_INT_INF)
    else:
        has_slot = active < slots
        key = active.astype(np.int64) * 2 - warm.astype(np.int64)
        score = np.where(has_slot, -key, -_INT_INF)  # maximise = least loaded
    return score, low_load


def _two_choices(u: float, n_workers: int) -> tuple[int, int]:
    """JSQ2's two candidates from one uniform: the integer part of ``u *
    W`` and its fractional part rescaled, in f64."""
    x = u * n_workers
    a = min(int(x), n_workers - 1)
    frac = x - np.floor(x)
    b = min(int(frac * n_workers), n_workers - 1)
    return a, b


def loc_np(cores: int, slots: int):
    def select(active, warm_col, func, func_home, u, idx):
        has_slot = active < slots
        if not has_slot.any():
            return -1
        W = active.shape[0]
        home = int(func_home[func])
        ring = (home + np.arange(W)) % W
        return int(ring[int(np.argmax(has_slot[ring]))])
    return select


def random_np(cores: int, slots: int):
    def select(active, warm_col, func, func_home, u, idx):
        has_slot = active < slots
        if not has_slot.any():
            return -1
        free_idx = np.nonzero(has_slot)[0]
        return int(free_idx[min(int(u * len(free_idx)), len(free_idx) - 1)])
    return select


def least_loaded_np(cores: int, slots: int):
    def select(active, warm_col, func, func_home, u, idx):
        has_slot = active < slots
        if not has_slot.any():
            return -1
        key = np.where(has_slot, active, _INT_INF)
        return int(np.argmin(key))
    return select


def hybrid_np(cores: int, slots: int):
    def select(active, warm_col, func, func_home, u, idx):
        if not (active < slots).any():
            return -1
        score, _ = hermes_score_np(active, warm_col, cores, slots)
        return int(np.argmax(score))
    return select


def jsq2_np(cores: int, slots: int):
    def select(active, warm_col, func, func_home, u, idx):
        has_slot = active < slots
        if not has_slot.any():
            return -1
        W = active.shape[0]
        a, b = _two_choices(float(u), W)
        key = np.where(has_slot, active, _INT_INF)
        w = b if key[b] < key[a] else a
        if not has_slot[w]:            # both sampled workers full
            w = int(np.argmin(key))
        return int(w)
    return select


def round_robin_np(cores: int, slots: int):
    def select(active, warm_col, func, func_home, u, idx):
        has_slot = active < slots
        if not has_slot.any():
            return -1
        W = active.shape[0]
        ring = (int(idx) % W + np.arange(W)) % W
        return int(ring[int(np.argmax(has_slot[ring]))])
    return select


def hiku_init_np(n_workers: int, n_functions: int) -> dict:
    """Every worker starts advertised (all are idle at t = 0)."""
    return {"ring": np.arange(n_workers, dtype=np.int32),
            "in_ring": np.ones(n_workers, dtype=np.int32),
            "head": np.int32(0),
            "tail": np.int32(n_workers)}


def hiku_np(cores: int, slots: int):
    def select(state, active, warm_col, func, func_home, u, idx):
        has_slot = active < slots
        if not has_slot.any():
            return -1, state
        if int(state["tail"]) > int(state["head"]):
            ring = state["ring"]
            cand = int(ring[int(state["head"]) % ring.shape[0]])
            in_ring = state["in_ring"].copy()
            in_ring[cand] = 0
            new = dict(state, head=np.int32(int(state["head"]) + 1),
                       in_ring=in_ring)
            # a popped worker is idle inside the engines; a placement made
            # outside them (the platform's re-dispatch) can fill it: then
            # least loaded, as the torch backend does
            if has_slot[cand]:
                return cand, new
            key = np.where(has_slot, active, _INT_INF)
            return int(np.argmin(key)), new
        key = np.where(has_slot, active, _INT_INF)
        return int(np.argmin(key)), state

    def on_complete(state, w, func, service, n_active_after):
        if n_active_after != 0 or int(state["in_ring"][w]) != 0:
            return state
        ring = state["ring"].copy()
        ring[int(state["tail"]) % ring.shape[0]] = w
        in_ring = state["in_ring"].copy()
        in_ring[w] = 1
        return dict(state, ring=ring, in_ring=in_ring,
                    tail=np.int32(int(state["tail"]) + 1))

    return select, on_complete


def dd_init_np(n_workers: int, n_functions: int) -> dict:
    return {"est": np.full(n_functions, DD_PRIOR_S, dtype=np.float64),
            "ew": np.zeros(n_workers, dtype=np.float64)}


def data_driven_np(cores: int, slots: int):
    def select(state, active, warm_col, func, func_home, u, idx):
        has_slot = active < slots
        if not has_slot.any():
            return -1, state
        key = np.where(has_slot, state["ew"], np.inf)
        w = int(np.argmin(key))
        ew = state["ew"].copy()
        ew[w] = ew[w] + state["est"][func]
        return w, dict(state, ew=ew)

    def on_complete(state, w, func, service, n_active_after):
        est = state["est"].copy()
        ew = state["ew"].copy()
        ew[w] = np.maximum(ew[w] - est[func], 0.0)
        est[func] = est[func] + DD_ALPHA * (service - est[func])
        return dict(state, est=est, ew=ew)

    return select, on_complete


def swarm_init_np(n_workers: int, n_functions: int) -> dict:
    return {"est": np.full(n_functions, SWARM_PRIOR_S, dtype=np.float64),
            "inv": np.ones(n_workers, dtype=np.float64),
            "cnt": np.zeros(n_workers, dtype=np.int64)}


def swarm_np(cores: int, slots: int):
    def select(state, active, warm_col, func, func_home, u, idx):
        has_slot = active < slots
        if not has_slot.any():
            return -1, state
        inv = state["inv"]
        key = np.where(has_slot,
                       np.where(active + 1 <= cores, inv,
                                (active + 1.0) * inv),
                       np.inf)
        return int(np.argmin(key)), state

    def on_complete(state, w, func, service, n_active_after):
        est = state["est"].copy()
        inv = state["inv"].copy()
        cnt = state["cnt"].copy()
        sample = service / est[func]
        est[func] = est[func] * (_SW_EST_UP if service > est[func]
                                 else _SW_EST_DN)
        hot = cnt[w] < SWARM_WARM_N
        inv[w] = inv[w] * ((_SW_HOT_UP if hot else _SW_COLD_UP)
                           if sample > inv[w]
                           else (_SW_HOT_DN if hot else _SW_COLD_DN))
        cnt[w] = cnt[w] + 1
        return dict(state, est=est, inv=inv, cnt=cnt)

    return select, on_complete
