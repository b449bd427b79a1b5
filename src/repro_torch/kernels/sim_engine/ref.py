"""Plain torch version of the fused early-binding event loop.

The same function as the CUDA kernel (``csrc/sim_engine.cu``) with the
kernel's control flow: a loop over replications, then over arrivals,
each advance loop reading its own replication's predicate (no lockstep
masking, no scratch index, no pad column), and the balancers in the
kernel's form (LL and LOC as a first-index argmin of the load and of the
ring distance from the function's home, R by rank among the workers with
a free slot, H through the Hermes score).  It returns what the port's
batched engine (``core/simulator.py``, ``backend="torch"``) returns, bit
for bit.  The CPU tests and the chip check hold the kernel against it.
"""
from __future__ import annotations

import torch

from repro_torch import NotPortedError
from repro_torch.kernels.hermes_select.ref import hermes_select_ref

EPS = 1e-9
_BIG_TIME = 1e18
_BIG = 1 << 30
_F64, _I32, _I64 = torch.float64, torch.int32, torch.int64
#: balancer name -> the kernel's code (``enum Balancer`` in the source)
BALANCER_CODES = {"H": 0, "LL": 1, "LOC": 2, "R": 3}


def balancer_name(balance) -> str:
    """``balance`` (a balancer name or its enum) if the fused engine has
    it (:data:`BALANCER_CODES`); :class:`NotPortedError` otherwise.  Which
    policies take this engine is the policy table's decision
    (:func:`repro_torch.policy.engine`), not the kernel's."""
    name = str(getattr(balance, "value", balance)).strip().upper()
    if name not in BALANCER_CODES:
        raise NotPortedError(
            f"sim_engine runs the balancers {', '.join(BALANCER_CODES)}; "
            f"got {name!r}")
    return name


def _choose(balance, active, warm_col, home_f, u, cores, slots):
    """Worker for one arrival, or -1 if every worker is slot-full."""
    has_slot = active < slots
    if not bool(has_slot.any()):
        return -1
    W = active.shape[0]
    if balance == "H":
        choices, _ = hermes_select_ref(active, warm_col[None],
                                       cores=cores, slots=slots)
        return int(choices[0])
    if balance == "R":
        k = has_slot.sum()
        target = int(torch.minimum((u * k).to(_I32), k - 1))
        return int(torch.nonzero(has_slot)[target, 0])
    if balance == "LL":
        key = active
    else:   # LOC: the first worker with a free slot on the home's ring
        key = (torch.arange(W, dtype=_I64, device=active.device)
               - home_f) % W
    return int(torch.where(has_slot, key, _BIG).argmin())


def sim_engine_ref(balance, cluster, arrival, func, service, u_lb, home):
    """Early binding with PS under the balancer ``balance`` (``"H"``,
    ``"LL"``, ``"LOC"`` or ``"R"``).  arrival, service, u_lb ``[R, N]`` f64; func ``[R, N]`` i32; home
    ``[R, F]`` i32 → dict of ``resp [R, N]`` f64 (NaN until completed),
    ``cold``/``rejected [R, N]`` bool, ``worker_of [R, N]`` i32,
    ``server_time``/``core_time``/``now [R]`` f64, ``iters [R]`` i64
    (advance iterations per replication) and ``active [R]`` i64 (the
    active tasks summed over those iterations: the slots a scan reads)."""
    balance = balancer_name(balance)
    W, C, S = int(cluster.n_workers), int(cluster.cores), int(cluster.slots)
    R, N = arrival.shape
    F = home.shape[1]
    dev = arrival.device
    out = dict(
        resp=torch.full((R, N), torch.nan, dtype=_F64, device=dev),
        cold=torch.zeros((R, N), dtype=torch.bool, device=dev),
        rejected=torch.zeros((R, N), dtype=torch.bool, device=dev),
        worker_of=torch.full((R, N), -1, dtype=_I32, device=dev),
        server_time=torch.zeros(R, dtype=_F64, device=dev),
        core_time=torch.zeros(R, dtype=_F64, device=dev),
        now=torch.zeros(R, dtype=_F64, device=dev),
        iters=torch.zeros(R, dtype=_I64, device=dev),
        active=torch.zeros(R, dtype=_I64, device=dev))
    c = torch.tensor(float(C), dtype=_F64, device=dev)
    pen = torch.tensor(float(cluster.cold_start_penalty), dtype=_F64,
                       device=dev)
    no_pen = torch.zeros((), dtype=_F64, device=dev)
    for r in range(R):
        remaining = torch.full((W, S), torch.inf, dtype=_F64, device=dev)
        task_arr = torch.zeros((W, S), dtype=_F64, device=dev)
        task_idx = torch.full((W, S), -1, dtype=_I32, device=dev)
        warm = torch.zeros((W, F), dtype=_I32, device=dev)
        resp = out["resp"][r]
        now = torch.zeros((), dtype=_F64, device=dev)
        server_time = torch.zeros((), dtype=_F64, device=dev)
        core_time = torch.zeros((), dtype=_F64, device=dev)
        iters = active_sum = 0
        for i in range(N + 1):
            dt_left = arrival[r, i] - now if i < N else \
                torch.tensor(_BIG_TIME, dtype=_F64, device=dev)
            while True:
                active = task_idx >= 0
                pending = bool((active & (remaining <= EPS)).any())
                if not (bool(active.any()) and (bool(dt_left > 0)
                                                or pending)):
                    break
                iters += 1
                n_w = active.sum(dim=1)
                active_sum += int(n_w.sum())
                rate = torch.clamp(c / n_w.clamp(min=1).to(_F64), max=1.0)
                rates = torch.where(active, rate[:, None], 0.0)
                t_done = torch.where(rates > 0, remaining / rates, torch.inf)
                tmin = t_done.amin()
                j = int(t_done.view(-1).argmin())
                wj, sj = divmod(j, S)
                tau = torch.minimum(dt_left, tmin)
                tau = torch.where(torch.isfinite(tau) & (tau > 0), tau, 0.0)
                server_time = server_time + tau * (n_w > 0).sum()
                core_time = core_time + tau * n_w.clamp(max=C).sum()
                now = now + tau
                tid = int(task_idx[wj, sj])
                completed = bool(tmin <= dt_left) or (
                    tid >= 0 and bool(remaining[wj, sj] <= EPS))
                remaining = remaining - rates * tau
                if completed and tid >= 0:
                    resp[tid] = now - task_arr[wj, sj]
                    warm[wj, int(func[r, tid])] += 1
                    remaining[wj, sj] = torch.inf
                    task_idx[wj, sj] = -1
                dt_left = dt_left - tau
            if i == N:
                break
            now = arrival[r, i]
            f = int(func[r, i])
            active = (task_idx >= 0).sum(dim=1).to(_I32)
            w = _choose(balance, active, warm[:, f], home[r, f], u_lb[r, i],
                        C, S)
            out["rejected"][r, i] = w < 0
            if w < 0:
                continue
            row, warm_row = task_idx[w], warm[w]
            is_cold = bool(warm_row[f] == 0)
            victim = int(warm_row.argmax())
            need_evict = is_cold and \
                int((row >= 0).sum()) + int(warm_row.sum()) >= S
            if not is_cold:
                warm_row[f] -= 1
            if need_evict:
                warm_row[victim] -= 1
            slot = int((row < 0).to(_I32).argmax())
            remaining[w, slot] = service[r, i] + (pen if is_cold else no_pen)
            task_arr[w, slot] = now
            task_idx[w, slot] = i
            out["cold"][r, i] = is_cold
            out["worker_of"][r, i] = w
        out["server_time"][r] = server_time
        out["core_time"][r] = core_time
        out["now"][r] = now
        out["iters"][r] = iters
        out["active"][r] = active_sum
    return out
