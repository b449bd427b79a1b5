"""``sim_engine``'s chunk mode (its plain version on the CPU) and the
timeline across chunk boundaries.

* fig14's six stacks beyond the balancers (E/LL/PS under each built-in
  keep-alive, E/LL/PS and E/SWARM/PS on a ``two-gen`` fleet, DD +
  HYBRID_HIST + ``two-gen`` + ``TARGET_P99``): the batched engine's stream
  at chunk sizes 1, 7, 96, N and N + 5 ends in the monolithic run's final
  state, bit for bit (``test_torch_streaming_bits.py`` holds the nine
  balancer stacks).
* ``sim_engine_chunk_ref`` (the kernel's chunk mode in plain torch) equals
  the batched engine's stream for all fifteen stacks at chunk 96: the
  per-arrival planes, the counters, the sketches, the clocks and
  integrals, the balancer's, life and fleet state, bit for bit (at chunk
  80 too for two stacks, and at every chunk boundary for two); its stream
  ends in its own monolithic run's state (the slot matrices and warm
  pools too).
* fig15's three early-binding parity stacks (``fig15_timeline.py:104-116``,
  ``PAR_TL``): the plain chunk mode's timeline (chunk 96) is its
  monolithic run's, bit for bit (``test_torch_streaming.py`` holds the
  batched engine's).
* The chunk mode's contract: a fresh start from ``None``, the caller's
  carry left as it was, a drain of its own equal to a drained last chunk,
  telemetry required.

The last test holds the CUDA kernel's chunk mode against its plain version
and runs only where a card is present.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import (E_DD_PS, E_LL_PS, E_SWARM_PS, HERMES, Binding,
                              ClusterCfg, FleetCfg, LifecycleCfg, PolicySpec,
                              WorkerSched, stack_workloads, synth_workload)
from repro_torch.core.simulator import simulate_many
from repro_torch.core.streaming import (final_states_equal,
                                        monolithic_state, simulate_stream)
from repro_torch.kernels.sim_engine import kernel, ops
from repro_torch.kernels.sim_engine.ref import sim_engine_ref
from repro_torch.policy import balancer_names
from repro_torch.telemetry import (N_BINS, TelemetryCfg, TimelineCfg,
                                   warmup_cutoff)

EQ = ClusterCfg(n_workers=4, cores=3, capacity_factor=2)
EQ_N = 240
EQ_LOADS = ((0.6, 0), (1.0, 1))
TWO_GEN = EQ._replace(fleet=FleetCfg(preset="two-gen"))
FULL = EQ._replace(
    lifecycle=LifecycleCfg(keepalive="HYBRID_HIST", ttl_s=2.0, max_idle=3,
                           coldstart="paper-sim"),
    fleet=FleetCfg(preset="two-gen", autoscale="TARGET_P99", min_workers=2,
                   target_p99=4.0, cooldown_s=2.0))
#: fig14's stacks beyond the balancers
OTHER = {
    **{f"E/LL/PS|ka={ka}": (E_LL_PS, EQ._replace(
        lifecycle=LifecycleCfg(keepalive=ka)))
       for ka in ("NONE", "FIXED_TTL", "HYBRID_HIST")},
    "E/LL/PS|fleet": (E_LL_PS, TWO_GEN),
    "E/SWARM/PS|fleet": (E_SWARM_PS, TWO_GEN),
    "E/DD/PS|ka=HYBRID_HIST|fleet|auto": (E_DD_PS, FULL),
}
#: all fifteen of fig14's stacks
FIG14 = {**{f"E/{b}/PS": (PolicySpec(Binding.EARLY, b, WorkerSched.PS), EQ)
            for b in balancer_names()}, **OTHER}
PAR_TL = TimelineCfg(n_windows=32, coarse_bins=96, max_events=128)
#: fig15's early-binding parity stacks
PARITY = {
    "E/LL/PS": (E_LL_PS, EQ),
    "E/H/PS|mode-flips": (HERMES, EQ),
    "E/LL/PS|fleet|auto": (E_LL_PS, EQ._replace(fleet=FleetCfg(
        preset="two-gen", autoscale="TARGET_P99", min_workers=2,
        target_p99=4.0, cooldown_s=2.0))),
}
TEL = TelemetryCfg()
TL_PLANES = ("window_s", "mode", "arrivals", "n_cold", "n_warm", "n_evict",
             "n_reject", "slow_hist", "lat_hist", "busy_time", "qlen_time",
             "prov_core", "n_on", "ev_t", "ev_kind", "ev_val", "ev_p99",
             "ev_count")


def _batch(cluster):
    return stack_workloads(synth_workload(cluster, load, EQ_N, n_functions=5,
                                          seed=seed)
                           for load, seed in EQ_LOADS)


def _inputs(wb, sl, device="cpu"):
    return [torch.as_tensor(np.ascontiguousarray(x[:, sl]), dtype=d,
                            device=device)
            for x, d in ((wb.arrival, torch.float64),
                         (wb.func, torch.int32),
                         (wb.service, torch.float64),
                         (wb.u_lb, torch.float64))]


def _plain_stream(policy, cluster, wb, chunk, timeline=None, device="cpu",
                  callback=None):
    """The fused engine's chunk mode chunk by chunk (the plain version on
    the CPU, the kernel on the card): the final carry and the per-arrival
    planes, numpy."""
    R, N = wb.n_reps, wb.n
    plan = ops.chunk_plan(policy.balance, cluster, R, wb.n_functions, device,
                          TEL, timeline)
    home = torch.as_tensor(wb.func_home, dtype=torch.int32, device=device)
    ws = None if timeline is None else \
        wb.arrival[:, -1] / np.float64(timeline.n_windows)
    carry, outs = None, []
    for g0 in range(0, N, chunk):
        sl = slice(g0, min(g0 + chunk, N))
        carry, o = ops.sim_engine_chunk(
            plan, carry, *_inputs(wb, sl, device), home, g0=g0,
            drain=sl.stop == N, cutoff=warmup_cutoff(N, TEL), window_s=ws)
        outs.append({k: v.cpu().numpy() for k, v in o.items()})
        if callback is not None:
            callback({k: v.cpu().clone() for k, v in carry.items()})
    planes = {k: np.concatenate([o[k] for o in outs], axis=1)
              for k in outs[0]}
    return carry, planes


def _as_fused(st: dict, F: int) -> dict:
    """The batched engine's carry in the fused engine's layout: no pad
    column, no dropped bin, no late-binding queue counters."""
    out = {}
    for k, v in st.items():
        if k in ("q_head", "q_tail") or k.startswith("tl_"):
            continue
        if k in ("warm", "life_idle_since"):
            v = v[:, :, :F]
        elif k in ("tel_slow_hist", "tel_lat_hist"):
            v = v[:, :N_BINS]
        elif k == "task_fn":
            v = v.to(torch.int32)
        out[k] = v
    return out


def _assert_fused_equals_batched(fused: dict, batched: dict, F: int,
                                 what: str):
    ours = _as_fused(batched, F)
    shared = set(fused) & set(ours)
    assert {"remaining", "task_idx", "task_fn", "task_svc", "warm",
            "stream_slow_sum", "tel_slow_hist"} <= shared, sorted(shared)
    for k in sorted(shared):
        a, b = fused[k].cpu().numpy(), ours[k].cpu().numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, (what, k)
        assert np.array_equal(a, b, equal_nan=True), (what, k)
    # only the fused engine's own counts are left over
    assert set(fused) - shared <= {"iters", "active", "busy_iters",
                                   "stream_rec_since"}, set(fused) - shared


@pytest.mark.parametrize("stack", OTHER)
def test_other_stacks_chunked_is_monolithic(stack):
    policy, cluster = OTHER[stack]
    wb = _batch(cluster)
    mono = monolithic_state(policy, cluster, wb, device="cpu", telemetry=TEL)
    plain = simulate_many(policy, cluster, wb, device="cpu", telemetry=TEL)
    for k in (1, 7, 96, EQ_N, EQ_N + 5):
        out = simulate_stream(policy, cluster, wb, chunk_size=k,
                              device="cpu", collect_outputs=True,
                              keep_final_state=True)
        ok, bad = final_states_equal(out.final_state, mono)
        assert ok, (k, bad)
        for f in ("cold", "rejected", "worker"):
            assert getattr(out, f).tobytes() == getattr(plain, f).tobytes(), \
                (k, f)
        np.testing.assert_array_equal(
            out.n_done, (~np.isnan(plain.response)).sum(1))


@pytest.mark.parametrize("stack,chunk", [
    *((s, 96) for s in FIG14),
    *((s, 80) for s in ("E/H/PS", "E/DD/PS|ka=HYBRID_HIST|fleet|auto"))])
def test_plain_chunk_mode_equals_the_batched_stream(stack, chunk):
    policy, cluster = FIG14[stack]
    wb = _batch(cluster)
    carry, planes = _plain_stream(policy, cluster, wb, chunk)
    out = simulate_stream(policy, cluster, wb, chunk_size=chunk,
                          device="cpu", collect_outputs=True,
                          keep_final_state=True)
    _assert_fused_equals_batched(carry, out.final_state, wb.n_functions,
                                 stack)
    assert planes["cold"].tobytes() == out.cold.tobytes()
    assert planes["rejected"].tobytes() == out.rejected.tobytes()
    assert planes["worker_of"].tobytes() == out.worker.tobytes()
    if chunk == 96:
        # and the plain chunk mode ends where its monolithic run does
        mono = sim_engine_ref(policy.balance, cluster,
                              *_inputs(wb, slice(None)),
                              torch.as_tensor(wb.func_home,
                                              dtype=torch.int32),
                              TEL, keep_state=True)
        ok, bad = final_states_equal(carry, mono)
        assert ok, bad
        assert planes["cold"].tobytes() == mono["cold"].numpy().tobytes()


@pytest.mark.parametrize("stack", ["E/H/PS",
                                   "E/DD/PS|ka=HYBRID_HIST|fleet|auto"])
def test_plain_chunk_mode_at_every_boundary(stack):
    policy, cluster = FIG14[stack]
    wb = _batch(cluster)
    fused, batched = [], []
    _plain_stream(policy, cluster, wb, 96, callback=fused.append)
    simulate_stream(policy, cluster, wb, chunk_size=96, device="cpu",
                    chunk_callback=lambda c, st: batched.append(
                        {k: v.clone() for k, v in st.items()}))
    assert len(fused) == len(batched) == 3
    for c, (a, b) in enumerate(zip(fused[:2], batched[:2])):
        _assert_fused_equals_batched(a, b, wb.n_functions, f"chunk {c}")


@pytest.mark.parametrize("stack", PARITY)
def test_plain_chunk_mode_carries_the_timeline(stack):
    policy, cluster = PARITY[stack]
    wb = _batch(cluster)
    carry, _ = _plain_stream(policy, cluster, wb, 96, timeline=PAR_TL)
    ref = sim_engine_ref(policy.balance, cluster, *_inputs(wb, slice(None)),
                         torch.as_tensor(wb.func_home, dtype=torch.int32),
                         TEL, PAR_TL)
    for f in TL_PLANES:
        assert carry[f"tl_{f}"].numpy().tobytes() == \
            ref[f"tl_{f}"].numpy().tobytes(), f
    assert int(carry["tl_arrivals"].sum()) == 2 * EQ_N


def test_chunk_mode_contract():
    wb = _batch(FULL)
    plan = ops.chunk_plan("DD", FULL, 2, 5, "cpu", TEL)
    home = torch.as_tensor(wb.func_home, dtype=torch.int32)
    cut = warmup_cutoff(EQ_N, TEL)
    first, _ = ops.sim_engine_chunk(plan, None, *_inputs(wb, slice(0, 150)),
                                    home, g0=0, drain=False, cutoff=cut)
    kept = {k: v.clone() for k, v in first.items()}
    # the last chunk drained, or left open and drained on its own
    a, _ = ops.sim_engine_chunk(plan, first, *_inputs(wb, slice(150, EQ_N)),
                                home, g0=150, drain=True, cutoff=cut)
    b, _ = ops.sim_engine_chunk(plan, first, *_inputs(wb, slice(150, EQ_N)),
                                home, g0=150, drain=False, cutoff=cut)
    empty = [x[:, :0] for x in _inputs(wb, slice(0, 0))]
    b, o = ops.sim_engine_chunk(plan, b, *empty, None, g0=EQ_N, drain=True,
                                cutoff=cut)
    assert o["cold"].shape == (2, 0)
    ok, bad = final_states_equal(a, b)
    assert ok and all(torch.equal(a[k], b[k]) for k in a), bad
    # the caller's carry is not changed
    assert all(torch.equal(first[k], kept[k]) for k in first)
    assert int(a["stream_n_done"].sum()) > int(first["stream_n_done"].sum())
    assert int((a["task_idx"] >= 0).sum()) == 0        # drained
    with pytest.raises(ValueError, match="telemetry"):
        ops.chunk_plan("LL", EQ, 2, 5, "cpu", None)
    before = kernel.sim_engine.launches
    ops.sim_engine_chunk(plan, None, *_inputs(wb, slice(0, 10)), home, g0=0,
                         drain=True, cutoff=cut)
    assert kernel.sim_engine.launches == before    # the CPU launches nothing


def test_cuda_chunk_mode_matches_its_plain_version():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    for stack, (policy, cluster) in FIG14.items():
        wb = _batch(cluster)
        for tl in (None, PAR_TL):
            card, cpu = [], []
            before = kernel.sim_engine.launches
            _, p_card = _plain_stream(policy, cluster, wb, 96, tl, "cuda",
                                      card.append)
            assert kernel.sim_engine.launches == before + 3
            _, p_cpu = _plain_stream(policy, cluster, wb, 96, tl, "cpu",
                                     cpu.append)
            for k in p_card:
                assert p_card[k].tobytes() == p_cpu[k].tobytes(), (stack, k)
            for a, b in zip(card, cpu):
                assert set(a) == set(b)
                for k in a:
                    assert np.array_equal(a[k].numpy(), b[k].numpy(),
                                          equal_nan=True), (stack, tl, k)
