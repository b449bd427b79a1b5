#!/usr/bin/env python3
"""Device times and outputs of the fused engine's runs in
``chip_smoke.py``'s phases 4, 12, 13, 14, 15 and 16, for comparing two
trees of the port on one card.

    python3 tools/sim_engine_ab.py --src PATH/src --out times.json
    python3 tools/sim_engine_ab.py --compare A.json B.json B2.json A2.json

The first form imports ``repro_torch`` from ``PATH/src`` (so one copy of
this script times any checkout that has the same ``simulate_many``),
builds its ``sim_engine`` and times, by CUDA events just around each
launch, the fused runs of phase 4 (fig4: E/{H,LL,LOC}/PS, W = 100,
N = 12 000, R = 4), phase 12 (fig10's full mode: the five ``azure-*``
scenarios × the three policies, R = 20; fig14's horizon lane, W = 1000,
N = 86 400), phase 13 (fig11's quick lanes, the nine policies; fig4's
five zoo rows), each without a lifecycle, phase 14 (fig12's budget
and balancer lanes and fig7's keep-alive axis, N = 15 000, R = 5, under
the lifecycle), none of these with telemetry or a fleet, and phase 15
under the observation plane (bench_telemetry's sketch lane at load 0.6
for the nine policies, 8 × 8 cores, N = 60 000, R = 5, with telemetry;
fig13's balancer and frontier lanes, N = 6000) and phase 16 under the
timeline (fig15's three early-binding parity stacks, its diurnal and
decision lanes, and fig4's E/H/PS inputs with telemetry, and with
telemetry and a timeline), each timed three times after a warm-up
launch.  It writes ``{run: [ms, digest]}`` as JSON: the
median of the three times, and a SHA-256 of every output tensor of the
launch (the same in all three, or it stops).  The second form reads the
JSON of runs made in turns in one call (old, new, new, old) and prints,
for each run and phase, the new tree's mean time over the old's, and
whether every run's outputs are the same bits in all of them.  It needs
a CUDA card.
"""
from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import sys
import types
from pathlib import Path

#: phase -> the fused runs' shapes, as chip_smoke.py makes them
LOADS = (0.5, 0.7, 0.9, 0.97)
AZURE = ("azure-diurnal", "azure-bursty", "azure-cold-heavy",
         "azure-flash-crowd", "azure-fixture")


def _runs():
    """(phase, key, policy, cluster, workload batch, telemetry[, timeline]),
    in phase order."""
    from repro_torch.core import (E_DD_PS, E_HIKU_PS, E_JSQ2_PS, E_LL_PS,
                                  E_LOC_PS, E_RR_PS, E_SWARM_PS, HERMES,
                                  PAPER_LARGE, PAPER_SMALL, PAPER_TESTBED,
                                  WORKLOADS, ZOO_POLICIES, ClusterCfg,
                                  bimodal_exec, ms_trace,
                                  replicate_workload)
    from repro_torch.policy import balancer_names
    fused = (HERMES, E_LL_PS, E_LOC_PS)
    zoo = (E_JSQ2_PS, E_RR_PS, E_HIKU_PS, E_DD_PS, E_SWARM_PS)
    fig4 = replicate_workload(ms_trace, PAPER_LARGE, LOADS, 12_000,
                              seeds=(1,))
    for p in fused:
        yield "4", f"fig4 {p.name}", p, PAPER_LARGE, fig4, None
    testbed = PAPER_TESTBED._replace(cold_start_penalty=0.5)
    for name in AZURE:
        wb = replicate_workload(WORKLOADS[name], testbed,
                                (0.3, 0.5, 0.7, 0.85), 12_000,
                                seeds=(1, 2, 3, 4, 5))
        for p in fused:
            yield "12", f"fig10 {name} {p.name}", p, testbed, wb, None
    lane_cl = ClusterCfg(n_workers=1000, cores=2, capacity_factor=2)
    lane = replicate_workload(WORKLOADS["azure-diurnal"], lane_cl, LOADS,
                              86_400, seeds=(1,))
    for p in fused:
        yield "12", f"horizon {p.name}", p, lane_cl, lane, None
    names = {p.name for p in ZOO_POLICIES}
    fig11 = list(ZOO_POLICIES) + [p for p in map(_early_ps, balancer_names())
                                  if p.name not in names]
    for lane_name, make in (("ms-trace", ms_trace),
                            ("bimodal-exec", bimodal_exec)):
        wb = replicate_workload(make, PAPER_SMALL, (0.5, 0.7, 0.8, 0.9),
                                6_000, seeds=(0,))
        for p in fig11:
            yield "13", f"fig11 {lane_name} {p.name}", p, PAPER_SMALL, wb, \
                None
    for p in zoo:
        yield "13", f"fig4 {p.name}", p, PAPER_LARGE, fig4, None
    yield from _keepalive_runs(fused)
    yield from _observation_runs(fig11)
    yield from _timeline_runs(fig4)


def _timeline_runs(fig4):
    """Phase 16's fused runs (fig15_timeline.py's parity, diurnal and
    decision lanes; the plane's cost on fig4's E/H/PS inputs)."""
    from repro_torch.core import (E_LL_PS, HERMES, PAPER_LARGE,
                                  PAPER_TESTBED, WORKLOADS, ClusterCfg,
                                  FleetCfg, stack_workloads, synth_workload)
    from repro_torch.telemetry import TelemetryCfg, TimelineCfg
    tel = TelemetryCfg()
    par = ClusterCfg(n_workers=4, cores=3, capacity_factor=2)
    par_tl = TimelineCfg(n_windows=32, coarse_bins=96, max_events=128)
    auto = par._replace(fleet=FleetCfg(
        preset="two-gen", autoscale="TARGET_P99", min_workers=2,
        target_p99=4.0, cooldown_s=2.0))
    for key, p, cl in (("E/LL/PS", E_LL_PS, par),
                       ("E/H/PS|mode-flips", HERMES, par),
                       ("E/LL/PS|fleet|auto", E_LL_PS, auto)):
        wb = stack_workloads(synth_workload(cl, load, 240, n_functions=5,
                                            seed=seed)
                             for load, seed in ((0.6, 0), (1.0, 1)))
        yield "16", f"fig15 parity {key}", p, cl, wb, tel, par_tl
    make = WORKLOADS["azure-diurnal"]
    yield "16", "fig15 diurnal E/LL/PS", E_LL_PS, PAPER_TESTBED, \
        stack_workloads([make(PAPER_TESTBED, 0.5, 4_000, seed=3)]), None, \
        TimelineCfg()
    dec = PAPER_TESTBED._replace(fleet=FleetCfg(
        preset="two-gen", autoscale="TARGET_P99", target_p99=3.0,
        min_workers=2, cooldown_s=2.0))
    yield "16", "fig15 decision HERMES", HERMES, dec, \
        stack_workloads([make(PAPER_TESTBED, 0.85, 6_000, seed=1)]), tel, \
        TimelineCfg(max_events=512)
    yield "16", "fig4 E/H/PS telemetry", HERMES, PAPER_LARGE, fig4, tel, None
    yield "16", "fig4 E/H/PS telemetry+timeline", HERMES, PAPER_LARGE, \
        fig4, tel, TimelineCfg()


def _observation_runs(policies):
    """Phase 15's runs (bench_telemetry's sketch lane at load 0.6, fig13's
    full mode on the testbed)."""
    from repro_torch.core import (E_LL_PS, E_SWARM_PS, HERMES,
                                  PAPER_TESTBED, WORKLOADS, ClusterCfg,
                                  FleetCfg, ms_trace, stack_workloads)
    from repro_torch.telemetry import TelemetryCfg
    tel_cl = ClusterCfg(n_workers=8, cores=8)
    wb = stack_workloads(ms_trace(tel_cl, 0.6, 60_000, seed=s)
                         for s in (17, 18, 19, 20, 21))
    for p in policies:
        yield "15", f"sketch {p.name}", p, tel_cl, wb, \
            TelemetryCfg(warmup_frac=0.1)
    make = WORKLOADS["azure-diurnal"]
    two_gen = PAPER_TESTBED._replace(fleet=FleetCfg(preset="two-gen"))
    for load in (0.5, 0.65, 0.8):
        wb = stack_workloads([make(PAPER_TESTBED, load, 6_000, seed=1)])
        for p in (HERMES, E_LL_PS, E_SWARM_PS):
            yield "15", f"fig13 balancer {load} {p.name}", p, two_gen, wb, \
                None
    auto = PAPER_TESTBED._replace(fleet=FleetCfg(
        preset="uniform", autoscale="TARGET_P99", target_p99=3.0,
        min_workers=2, cooldown_s=2.0))
    for seed in (1, 2, 3):
        wb = stack_workloads([make(PAPER_TESTBED, 0.85, 6_000, seed=seed)])
        for wn in (5, 6, 7, 8):
            yield "15", f"fig13 frontier {seed} static-{wn}", HERMES, \
                ClusterCfg(n_workers=wn, cores=PAPER_TESTBED.cores), wb, None
        yield "15", f"fig13 frontier {seed} auto", HERMES, auto, wb, \
            TelemetryCfg()


def _keepalive_runs(fused):
    """Phase 14's runs (fig12_keepalive.py's and fig7_coldstarts.py's
    full modes on the testbed, TTL 10 s, the ``openwhisk`` preset)."""
    from repro_torch.core import (PAPER_TESTBED, WORKLOADS, LifecycleCfg,
                                  replicate_workload)
    keepalives = ("NONE", "FIXED_TTL", "HYBRID_HIST")
    fig12, fig7 = (0.2, 0.3, 0.5, 0.7, 0.85), (0.1, 0.3, 0.5, 0.7, 0.9)

    def life(keepalive, max_idle=0):
        return PAPER_TESTBED._replace(lifecycle=LifecycleCfg(
            keepalive, 10.0, max_idle, "openwhisk"))

    def batch(name, loads):
        return replicate_workload(WORKLOADS[name], PAPER_TESTBED, loads,
                                  15_000, seeds=(1,))
    budget = batch("azure-cold-heavy", fig12)
    for ka in keepalives:
        yield "14", f"fig12 budget {ka} {fused[0].name}", fused[0], \
            life(ka, 4), budget, None
    diurnal = batch("azure-diurnal", fig12)
    for p in fused:
        yield "14", f"fig12 balancer FIXED_TTL {p.name}", p, \
            life("FIXED_TTL"), diurnal, None
    for name in ("ms-trace", "azure-diurnal"):
        wb = batch(name, fig7)
        for ka in keepalives:
            for p in fused:
                yield "14", f"fig7 {name} {ka} {p.name}", p, life(ka), wb, \
                    None


def _early_ps(balancer):
    from repro_torch.core import Binding, PolicySpec, WorkerSched
    return PolicySpec(Binding.EARLY, balancer, WorkerSched.PS)


def measure(src: Path) -> dict:
    sys.path.insert(0, str(src))
    import torch

    from repro_torch.core.simulator import simulate_many
    from repro_torch.kernels.sim_engine import kernel, ops
    from repro_torch.policy import engine

    if not torch.cuda.is_available():
        raise SystemExit("sim_engine_ab: needs a CUDA card")
    seen = []

    def timed(*args):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
        start.record()
        res = kernel.sim_engine(*args)
        end.record()
        seen.append((start, end, res))
        return res

    ops.kernel = types.SimpleNamespace(sim_engine=timed)
    times, warm = {}, set()
    for phase, key, policy, cluster, wb, tel, *tl in _runs():
        tl = tl[0] if tl else None
        if engine(policy, "cuda") != "sim_engine":
            continue
        if (policy.name, cluster, tel, tl) not in warm:
            # a short launch first: module load and first-use costs
            simulate_many(policy, cluster, dataclasses.replace(wb, **{
                f: getattr(wb, f)[:, :50] for f in ("arrival", "func",
                                                    "service", "u_lb")}),
                device="cuda", telemetry=tel, timeline=tl)
            warm.add((policy.name, cluster, tel, tl))
        seen.clear()
        for _ in range(3):
            simulate_many(policy, cluster, wb, device="cuda", telemetry=tel,
                          timeline=tl)
        torch.cuda.synchronize()
        digests = set()
        for _, _, res in seen:
            digest = hashlib.sha256()
            for name in sorted(res):
                digest.update(name.encode())
                digest.update(res[name].cpu().numpy().tobytes())
            digests.add(digest.hexdigest())
        if len(digests) != 1:
            raise SystemExit(f"sim_engine_ab: {key}: three launches on the "
                             f"same inputs gave different outputs")
        ms = sorted(start.elapsed_time(end) for start, end, _ in seen)
        times[f"{phase} {key}"] = [ms[1], digests.pop()]
        print(f"{phase} {key}: {times[f'{phase} {key}'][0]:.3f} ms",
              flush=True)
    return times


def compare(paths) -> None:
    runs = [json.loads(Path(p).read_text()) for p in paths]
    old = [r for i, r in enumerate(runs) if i in (0, len(runs) - 1)]
    new = [r for i, r in enumerate(runs) if i not in (0, len(runs) - 1)]
    by_phase: dict[str, list[float]] = {}
    differ = [key for key in old[0]
              if len({r[key][1] for r in runs}) != 1]
    for key in old[0]:
        o = sum(r[key][0] for r in old) / len(old)
        n = sum(r[key][0] for r in new) / len(new)
        by_phase.setdefault(key.split()[0], []).append(n / o)
        print(f"{key}: old {o:.3f} ms, new {n:.3f} ms, new / old "
              f"{n / o:.4f}")
    for phase, ratios in by_phase.items():
        print(f"phase {phase}: new / old over {len(ratios)} runs: min "
              f"{min(ratios):.4f}, mean {sum(ratios) / len(ratios):.4f}, "
              f"max {max(ratios):.4f}")
    print(f"outputs: {len(old[0]) - len(differ)} of {len(old[0])} runs "
          f"the same bits in all {len(runs)} measurements"
          + (f"; differ: {', '.join(differ)}" if differ else ""))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", type=Path)
    ap.add_argument("--out", type=Path)
    ap.add_argument("--compare", nargs="+")
    args = ap.parse_args()
    if args.compare:
        compare(args.compare)
        return 0
    times = measure(args.src.resolve())
    args.out.write_text(json.dumps(times, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
