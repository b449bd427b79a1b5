"""ctypes binding of the ``sim_engine`` CUDA kernel.

The kernel (``src/repro_torch/csrc/sim_engine.cu``) runs a whole
early-binding, processor-sharing ``simulate_many`` (E/<B>/PS for every
balancer of :data:`.ref.BALANCER_CODES`) in one launch, one block per
replication; its Hermes choice redesigns the Pallas TPU kernel
``repro/kernels/hermes_select/kernel.py`` (``hermes_select_batch``) for
the card.  :func:`sim_engine` checks its inputs, allocates the state and
the outputs (a carried-state balancer's state initialised by its
``init_state``, under a lifecycle the life plane's state initialised by
:func:`.ref.life_plane`, under telemetry, a fleet or a timeline the
observation plane's by :func:`.ref.obs_plane`, and under a timeline its
planes, zeroed, with each replication's window width), launches on
PyTorch's current stream and raises if the launch was refused.

:func:`sim_engine_chunk` launches the kernel's chunk mode: one chunk of a
stream's arrivals from the carry the last chunk left (the state tensors
of :func:`.ref.chunk_init`, updated in place), the drain only when asked
for, completions reading the slot mirrors and adding to the stream's
counters.  ``sim_engine.launches`` counts the launches of both.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.kernel import UnsupportedShapeError
from repro_torch.policy import INIT_STATE
from repro_torch.telemetry.timeline import validate_timeline
from repro_torch.telemetry.timeline_engine import widths

from .ref import (BALANCER_CODES, ChunkPlan, balancer_name, chunk_init,
                  life_plane, obs_plane)

#: the kernel keeps two ints per worker and a rate per slot count in
#: shared memory
MAX_WORKERS = 4096
MAX_SLOTS = 2047


@functools.cache
def _launcher(life: bool, mode: int):
    """The launch function of the library part that holds the kernels of
    this lifecycle switch and observation mode (0 off, 1 observation, 2
    observation and timeline); see ``_build.PARTS``."""
    fn = _build.load(f"sim_engine@{3 * int(life) + mode}").sim_engine_launch
    fn.argtypes = [ctypes.c_void_p] * 31 + [ctypes.c_int] * 2 \
        + [ctypes.c_double] * 2 + [ctypes.c_void_p] * 13 \
        + [ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_int] \
        + [ctypes.c_double] * 3 + [ctypes.c_void_p] * 13 \
        + [ctypes.c_int] * 12 + [ctypes.c_double, ctypes.c_void_p] \
        + [ctypes.c_int] * 2 + [ctypes.c_longlong] + [ctypes.c_void_p] * 4
    fn.restype = ctypes.c_int
    return fn


def _check(name: str, x: torch.Tensor, dtype, shape, device) -> None:
    if not x.is_cuda or x.device != device:
        raise ValueError(f"sim_engine: {name} must be a CUDA tensor on "
                         f"{device}, got one on {x.device}")
    if x.dtype != dtype:
        raise ValueError(f"sim_engine: {name} must be {dtype}, got "
                         f"{x.dtype}")
    if tuple(x.shape) != tuple(shape) or not x.is_contiguous():
        raise ValueError(f"sim_engine: {name} must be a contiguous "
                         f"{tuple(shape)} tensor, got {tuple(x.shape)}")


def _timeline_state(timeline, R: int, W: int, arrival, dev) -> dict:
    """The timeline plane's tensors for the kernel, zeroed (``ev_p99`` at
    NaN, ``mode`` at 1), with the window counters as one ``[R, 5, K]``
    tensor and each replication's width."""
    K, B = int(timeline.n_windows), int(timeline.coarse_bins)
    E = int(timeline.max_events)

    def zeros(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=dev)

    return dict(
        window_s=widths(arrival, timeline).contiguous(),
        counts=zeros((R, 5, K), torch.int64),
        slow_hist=zeros((R, K, B), torch.int64),
        lat_hist=zeros((R, K, B), torch.int64),
        busy_time=zeros((R, K, W), torch.float64),
        prov_core=zeros((R, K), torch.float64),
        n_on=zeros((R, K), torch.int32),
        ev_t=zeros((R, E), torch.float64),
        ev_kind=zeros((R, E), torch.int32),
        ev_val=zeros((R, E), torch.int32),
        ev_p99=torch.full((R, E), torch.nan, dtype=torch.float64,
                          device=dev),
        ev_count=zeros(R, torch.int64),
        mode=torch.ones(R, dtype=torch.int32, device=dev))


#: the timeline's window counters, in the kernel's order
TL_COUNTERS = ("arrivals", "n_cold", "n_warm", "n_evict", "n_reject")
#: the observation plane's counters and the stream's, in the kernel's order
TEL_COUNTERS = ("n_cold", "n_warm", "n_evict", "n_reject")
STREAM_COUNTS = ("stream_n_done", "stream_n_obs", "stream_rec_since")
STREAM_SUMS = ("stream_resp_sum", "stream_slow_sum")


def _ptr(x) -> int:
    return 0 if x is None else x.data_ptr()


def _launch(balance, cluster, n, F, inputs, state, outs, scalars, lb, life,
            ls, obs, obs_state, counters, tl, timeline, tel_on,
            chunk_args=(0, 1, 0, None, None, None, None)) -> None:
    """One launch: ``inputs`` (arrival, func, service, u_lb, home),
    ``state`` (remaining, task_arr, task_idx, warm), ``outs`` (resp, cold,
    rejected, worker_of), ``scalars`` (server_time, core_time, now, iters,
    active), the balancer's, life and observation state, the packed
    counters, the timeline's tensors (``counts`` packed) and the chunk
    mode's (chunk, drain, g0, task_fn, task_svc, stream counts and
    sums)."""
    W, C, S = int(cluster.n_workers), int(cluster.cores), int(cluster.slots)
    R = state[0].shape[0]
    ptrs = [_ptr(x) for x in (*inputs, *state, *outs, *scalars)]
    # the kernel's balancer-state arguments; null where unused (DD's ew
    # and SWARM's inv share the per-worker f64 slot)
    per_worker = lb.get("ew", lb.get("inv"))
    ptrs += [_ptr(x) for x in (
        lb.get("ring"), lb.get("in_ring"), lb.get("head"), lb.get("tail"),
        lb.get("est"), per_worker, lb.get("cnt"))]
    # the life plane's arguments; null (and 0) without a lifecycle
    ptrs += [_ptr(x) for x in (
        ls.get("life_idle_since"), ls.get("life_pre"), ls.get("life_keep"),
        None if life is None else life.costs, ls.get("life_hist"),
        ls.get("life_n_obs"))]
    life_args = (0, 0, 0.0, 0.0) if life is None else (
        1, life.max_idle, life.bin_s, life.ttl)
    # the observation plane's arguments; null (and 0) without one
    obs_ptrs = [_ptr(x) for x in (
        None if obs is None else obs.speed,
        None if obs is None else obs.edges,
        obs_state.get("tel_slow_hist"), obs_state.get("tel_lat_hist"),
        counters, obs_state.get("tel_busy_time"),
        obs_state.get("tel_depth_time"), obs_state.get("tel_decisions"),
        obs_state.get("busy_iters"), obs_state.get("fleet_n_on"),
        obs_state.get("fleet_cool_until"), obs_state.get("fleet_prov_time"),
        obs_state.get("fleet_snap"))]
    obs_args = (0, 0, 0, 1, 0.0, 0.0, 0.0) if obs is None else (
        1, obs.cutoff, int(obs.auto), obs.min_workers, obs.hi, obs.lo,
        obs.cooldown)
    # the timeline's arguments; null (and 0) without one
    tl_ptrs = [0 if tl is None else tl[k].data_ptr() for k in (
        "window_s", "counts", "slow_hist", "lat_hist", "busy_time",
        "prov_core", "n_on", "ev_t", "ev_kind", "ev_val", "ev_p99",
        "ev_count", "mode")]
    tl_args = (0, 1, 1, 1, 0) if tl is None else (
        1, int(timeline.n_windows), int(timeline.coarse_bins),
        int(timeline.max_events), int(tel_on))
    chunk, drain, g0, *chunk_ptrs = chunk_args
    dev = state[0].device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        mode = 0 if obs is None else 1 if tl is None else 2
        err = _launcher(life is not None, mode)(
            *ptrs, *life_args, *obs_ptrs, *obs_args, *tl_ptrs, *tl_args, R,
            n, F, W, C, S, BALANCER_CODES[balance],
            float(cluster.cold_start_penalty), stream, chunk, drain, g0,
            *(_ptr(x) for x in chunk_ptrs))
    if err != 0:
        raise RuntimeError(f"sim_engine: kernel launch failed with CUDA "
                           f"error {err}")
    sim_engine.launches += 1


def _check_cluster(cluster) -> None:
    W, S = int(cluster.n_workers), int(cluster.slots)
    if not (1 <= W <= MAX_WORKERS and 1 <= S <= MAX_SLOTS):
        raise UnsupportedShapeError(
            f"sim_engine: needs 1 <= W <= {MAX_WORKERS} and 1 <= S <= "
            f"{MAX_SLOTS}, got W={W}, S={S}")


def sim_engine(balance, cluster, arrival, func, service, u_lb, home,
               telemetry=None, timeline=None, keep_state=False):
    """The fused engine on the card: see :func:`.ref.sim_engine_ref` for
    the inputs and the outputs.  Raises :class:`NotPortedError` for a
    balancer, a keep-alive, an autoscaler or a speed preset it does not
    have and :class:`UnsupportedShapeError` for a cluster larger than it
    takes."""
    balance = balancer_name(balance)
    _check_cluster(cluster)
    W, S = int(cluster.n_workers), int(cluster.slots)
    dev = arrival.device
    R, N = arrival.shape if arrival.dim() == 2 else (0, 0)
    F = home.shape[-1]
    _check("arrival", arrival, torch.float64, (R, N), dev)
    _check("func", func, torch.int32, (R, N), dev)
    _check("service", service, torch.float64, (R, N), dev)
    _check("u_lb", u_lb, torch.float64, (R, N), dev)
    _check("home", home, torch.int32, (R, F), dev)
    if R < 1 or F < 1:
        raise UnsupportedShapeError(f"sim_engine: needs R >= 1 and F >= 1, "
                                    f"got R={R}, F={F}")

    def empty(shape, dtype):
        return torch.empty(shape, dtype=dtype, device=dev)

    state = [empty((R, W, S), torch.float64), empty((R, W, S), torch.float64),
             empty((R, W, S), torch.int32), empty((R, W, F), torch.int32)]
    out = dict(resp=empty((R, N), torch.float64),
               cold=empty((R, N), torch.bool),
               rejected=empty((R, N), torch.bool),
               worker_of=empty((R, N), torch.int32),
               server_time=empty((R,), torch.float64),
               core_time=empty((R,), torch.float64),
               now=empty((R,), torch.float64),
               iters=empty((R,), torch.int64),
               active=empty((R,), torch.int64))
    lb = INIT_STATE[balance](R, W, F, dev) if balance in INIT_STATE else {}
    life = life_plane(cluster, R, W, F, dev)
    ls = {} if life is None else life.state
    # the counters go to the kernel as one [R, 4] tensor
    obs = obs_plane(cluster, telemetry, R, N, W, dev, timeline)
    obs_state = {} if obs is None else obs.state
    counters = None if obs is None else torch.zeros(
        (R, 4), dtype=torch.int64, device=dev)
    tl = None
    if timeline is not None:
        validate_timeline(timeline)
        tl = _timeline_state(timeline, R, W, arrival, dev)
    _launch(balance, cluster, N, F,
            (arrival, func, service, u_lb, home), state,
            list(out.values())[:4], list(out.values())[4:], lb, life, ls,
            obs, obs_state, counters, tl, timeline, telemetry is not None)
    out.update({f"lb_{k}": v for k, v in lb.items()})
    out.update(ls)
    if obs is not None:
        for k, name in enumerate(TEL_COUNTERS):
            obs_state[f"tel_{name}"] = counters[:, k].contiguous()
        out.update(obs.returned())
    if tl is not None:
        counts = tl.pop("counts")
        for k, name in enumerate(TL_COUNTERS):
            tl[name] = counts[:, k].contiguous()
        # the queue-length integral stays 0 under early binding
        tl["qlen_time"] = torch.zeros((R, int(timeline.n_windows)),
                                      dtype=torch.float64, device=dev)
        out.update({f"tl_{k}": v for k, v in tl.items()})
    if keep_state:
        out.update(zip(("remaining", "task_arr", "task_idx", "warm"), state))
    return out


def sim_engine_chunk(plan: ChunkPlan, carry, arrival, func, service, u_lb,
                     home, g0: int, drain: bool, cutoff: int,
                     window_s=None):
    """One chunk of a stream on the card: see
    :func:`.ref.sim_engine_chunk_ref`.  The carry's tensors are updated in
    place (and the new carry returned); ``home`` may be None for a chunk
    without arrivals.  No host sync."""
    cluster = plan.cluster
    _check_cluster(cluster)
    dev, R, F = plan.device, plan.n_reps, plan.n_functions
    n = arrival.shape[1] if arrival.dim() == 2 else -1
    _check("arrival", arrival, torch.float64, (R, n), dev)
    _check("func", func, torch.int32, (R, n), dev)
    _check("service", service, torch.float64, (R, n), dev)
    _check("u_lb", u_lb, torch.float64, (R, n), dev)
    if home is not None:
        _check("home", home, torch.int32, (R, F), dev)
    elif n > 0:
        raise ValueError("sim_engine: a chunk with arrivals needs home")
    st = dict(chunk_init(plan, window_s) if carry is None else carry)
    outs = dict(rejected=torch.empty((R, n), dtype=torch.bool, device=dev),
                cold=torch.empty((R, n), dtype=torch.bool, device=dev),
                worker_of=torch.empty((R, n), dtype=torch.int32, device=dev))
    lb = {k[3:]: v for k, v in st.items() if k.startswith("lb_")}
    obs, tln = plan.obs, plan.timeline
    counters = torch.stack([st[f"tel_{k}"] for k in TEL_COUNTERS], dim=1)
    tl = None
    if tln is not None:
        tl = {k[3:]: v for k, v in st.items() if k.startswith("tl_")}
        tl["counts"] = torch.stack([tl[k] for k in TL_COUNTERS], dim=1)
    counts = torch.stack([st[k] for k in STREAM_COUNTS], dim=1)
    sums = torch.stack([st[k] for k in STREAM_SUMS], dim=1)
    # the observation plane's cutoff is the horizon's
    obs_c = dataclasses.replace(obs, cutoff=int(cutoff))
    _launch(plan.balance, cluster, n, F, (arrival, func, service, u_lb, home),
            [st[k] for k in ("remaining", "task_arr", "task_idx", "warm")],
            [None, outs["cold"], outs["rejected"], outs["worker_of"]],
            [st[k] for k in ("server_time", "core_time", "now", "iters",
                             "active")],
            lb, plan.life, st, obs_c, st, counters, tl, tln, True,
            (1, int(bool(drain)), int(g0), st["task_fn"], st["task_svc"],
             counts, sums))
    for k, name in enumerate(TEL_COUNTERS):
        st[f"tel_{name}"] = counters[:, k]
    if tl is not None:
        for k, name in enumerate(TL_COUNTERS):
            st[f"tl_{name}"] = tl["counts"][:, k]
    for k, name in enumerate(STREAM_COUNTS):
        st[name] = counts[:, k]
    for k, name in enumerate(STREAM_SUMS):
        st[name] = sums[:, k]
    return st, outs


sim_engine.launches = 0
