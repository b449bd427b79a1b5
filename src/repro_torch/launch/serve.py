"""Serving launcher of the port: a Hermes-scheduled cluster over a
request trace (counterpart of ``repro/launch/serve.py``, the same flags).

* ``--backend platform`` (default): the event-driven serving platform
  (:class:`repro_torch.serving.engine.ServingCluster`: cold starts,
  straggler re-dispatch, the lifecycle, the fleet and its autoscaler,
  telemetry and the timeline), any ``T/LB/S`` policy, its dispatch
  decisions on the card.
* ``--backend models``: real models behind the Hermes frontend
  (:class:`repro_torch.serving.backends.HermesFrontend`, 2 workers × 2
  cores), the reference's two registrations (``olmo-tiny`` and
  ``rwkv-tiny``, the smoke configs of olmo-1b and rwkv6-3b with their
  own ``attn_impl``), measured cold starts; ``--keepalive`` (checked
  against the lifecycle registry) expires idle executors after
  ``--ttl`` seconds.

Workloads are any ``repro_torch.core.WORKLOADS`` entry (the synthetic
§6.1 generators and the ``azure-*`` trace-replay scenarios) or an
Azure-schema trace slice given as the two dataset CSVs
(:mod:`repro_torch.trace`).  ``--keepalive``, ``--cold-start-preset``,
``--fleet-preset``, ``--speed`` and ``--autoscale`` are checked against
their registries with named errors.  The printed lines are the
reference launcher's.

Examples::

    python -m repro_torch.launch.serve --policy E/H/PS --load 0.6 -n 5000
    python -m repro_torch.launch.serve --workload azure-diurnal --load 0.7
    python -m repro_torch.launch.serve --keepalive HYBRID_HIST --ttl 30 \
        --cold-start-preset aws-lambda
    python -m repro_torch.launch.serve --workload azure-diurnal \
        --autoscale TARGET_P99 --target-p99 3 --min-workers 2 --cooldown 2
    python -m repro_torch.launch.serve --timeline-out runs/tl.csv
    python -m repro_torch.launch.serve --backend models --requests 12
"""
from __future__ import annotations

import argparse


def serve_models(args, device) -> None:
    """``--backend models``: ``args.requests`` invocations alternating the
    two registered functions, prompts of 8 tokens from
    ``default_rng(0)``, 4 new tokens each, one line a request in the
    reference's format.  The models run on ``device`` (``None``: the
    card)."""
    import numpy as np

    from repro_torch import configs
    from repro_torch.lifecycle import parse_keepalive
    from repro_torch.serving.backends import (HermesFrontend, Invocation,
                                              ModelRegistry)
    reg = ModelRegistry()
    reg.register("olmo-tiny", configs.get_smoke("olmo-1b"))
    reg.register("rwkv-tiny", configs.get_smoke("rwkv6-3b"))
    # keep-alive maps to executor idle expiry with the --ttl window (cold
    # starts here are measured, so --cold-start-preset does not apply);
    # the name is still checked against the lifecycle registry
    keepalive_s = None
    if args.keepalive is not None:
        parse_keepalive(args.keepalive)          # named ValueError
        keepalive_s = args.ttl
    fe = HermesFrontend(reg, n_workers=2, cores=2, max_len=64,
                        keepalive_s=keepalive_s, device=device)
    rng = np.random.default_rng(0)
    for i in range(args.requests):
        fn = ("olmo-tiny", "rwkv-tiny")[i % 2]
        out = fe.dispatch(Invocation(
            func=fn, prompt=rng.integers(0, 100, 8), n_new=4))
        print(f"req {i:2d} {fn:10s} worker={out.worker} "
              f"{'COLD' if out.cold else 'warm'} "
              f"{out.response_s*1e3:8.1f}ms")


def main(argv=None, device=None) -> None:
    """Parse ``argv`` (``None``: the command line) and run; the models or
    the platform's dispatch decisions run on ``device`` (``None``: the
    card)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--backend", choices=["platform", "models"],
                    default="platform")
    ap.add_argument("--policy", default="E/H/PS",
                    help="T/LB/S triple over the repro_torch.policy table "
                         "(e.g. E/H/PS, E/JSQ2/PS, L/*/*)")
    ap.add_argument("--workload", default="ms-trace",
                    help="any repro_torch.core.WORKLOADS name, incl. azure-* "
                         "trace-replay scenarios")
    ap.add_argument("--trace-invocations", metavar="CSV",
                    help="Azure-schema invocations-per-minute file; "
                         "replayed instead of --workload")
    ap.add_argument("--trace-durations", metavar="CSV",
                    help="Azure-schema duration-percentiles file "
                         "(required with --trace-invocations)")
    ap.add_argument("--load", type=float, default=0.6)
    ap.add_argument("-n", type=int, default=4000)
    ap.add_argument("--workers", type=int, default=8)
    ap.add_argument("--cores", type=int, default=12)
    ap.add_argument("--cold-start", type=float, default=0.5)
    ap.add_argument("--keepalive", metavar="NAME",
                    help="container keep-alive policy from the "
                         "repro_torch.lifecycle registry (NONE, FIXED_TTL, "
                         "HYBRID_HIST, ...); omit for the legacy "
                         "keep-forever warm pool")
    ap.add_argument("--ttl", type=float, default=60.0,
                    help="keep-alive window seconds (FIXED_TTL window / "
                         "HYBRID_HIST fallback+range unit)")
    ap.add_argument("--max-idle", type=int, default=0,
                    help="per-worker warm-pool budget (idle executors; "
                         "0 = bounded only by slot pressure)")
    ap.add_argument("--cold-start-preset", metavar="NAME",
                    default="scalar",
                    help="per-function cold-start latency preset from "
                         "the lifecycle registry ('scalar' keeps "
                         "--cold-start)")
    ap.add_argument("--fleet-preset", metavar="NAME",
                    help="per-worker speed preset from the repro_torch.fleet "
                         "registry (uniform, two-gen, long-tail, ...); "
                         "omit (with no other fleet flag) for the "
                         "homogeneous pool")
    ap.add_argument("--speed", nargs="+", type=float, metavar="S",
                    help="explicit per-worker speed vector (overrides "
                         "--fleet-preset; length must equal --workers)")
    ap.add_argument("--autoscale", metavar="NAME",
                    help="active-worker autoscale policy from the "
                         "repro_torch.fleet registry (STATIC, TARGET_P99, "
                         "...)")
    ap.add_argument("--target-p99", type=float, default=5.0,
                    help="autoscaler p99 slowdown ceiling")
    ap.add_argument("--min-workers", type=int, default=1,
                    help="autoscaler floor on active workers")
    ap.add_argument("--cooldown", type=float, default=60.0,
                    help="seconds between autoscale decisions")
    ap.add_argument("--hysteresis", type=float, default=0.1,
                    help="autoscaler dead-band half-width (fraction of "
                         "the setpoint)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--use-kernel", action="store_true",
                    help="dispatch through the balancer's CUDA "
                         "controller kernel (policies whose balancer "
                         "ships one, e.g. E/H/*)")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--telemetry", action="store_true",
                    help="collect streaming platform telemetry "
                         "(repro_torch.telemetry) and print its summary; "
                         "with --trace-out also records per-task "
                         "virtual-time lifecycle events")
    ap.add_argument("--trace-out", metavar="PATH", default=None,
                    help="export a Perfetto-loadable Chrome trace JSON "
                         "of the run (implies --telemetry)")
    ap.add_argument("--timeline-out", metavar="PATH", default=None,
                    help="record the windowed flight-recorder timeline "
                         "(repro_torch.telemetry.timeline) and export it: "
                         "per-window CSV at PATH plus an OpenMetrics "
                         "text sibling at PATH.om; with --trace-out "
                         "the windows also land in the trace JSON as "
                         "Perfetto counter tracks")
    args = ap.parse_args(argv)

    if args.backend == "models":
        serve_models(args, device)
        return

    from repro_torch.core import (ClusterCfg, WORKLOADS, parse_policy,
                                  summarize)
    from repro_torch.fleet import STATIC, fleet_from_flags, get_autoscaler
    from repro_torch.lifecycle import lifecycle_from_flags
    from repro_torch.serving.engine import ServeCfg, ServingCluster
    # named ValueError on unknown names; a preset or budget without an
    # explicit --keepalive gets an infinite window
    lifecycle = lifecycle_from_flags(args.keepalive, args.ttl,
                                     args.max_idle, args.cold_start_preset)
    # the fleet's axes: all defaults -> fleet=None
    fleet = fleet_from_flags(args.fleet_preset, args.speed, args.autoscale,
                             args.target_p99, args.min_workers,
                             args.cooldown, args.hysteresis)
    cl = ClusterCfg(n_workers=args.workers, cores=args.cores,
                    lifecycle=lifecycle, fleet=fleet).validate()
    if args.trace_invocations or args.trace_durations:
        if not (args.trace_invocations and args.trace_durations):
            ap.error("--trace-invocations and --trace-durations "
                     "must be given together")
        from repro_torch.trace.cache import load_trace_cached
        from repro_torch.trace.replay import replay_trace
        trace = load_trace_cached(args.trace_invocations,
                                  args.trace_durations,
                                  allow_missing_durations=True)
        wl = replay_trace(trace, cl, load=args.load, n_arrivals=args.n,
                          seed=args.seed, name="trace-file")
        wname = args.trace_invocations
    else:
        wl = WORKLOADS[args.workload](cl, args.load, args.n,
                                      seed=args.seed)
        wname = args.workload
    # a sketch-reading autoscaler needs telemetry whether or not a
    # summary was asked for
    auto_needs_tel = (fleet is not None and
                      get_autoscaler(fleet.autoscale).needs_telemetry)
    telemetry_on = bool(args.telemetry or args.trace_out or auto_needs_tel)
    tel_cfg = None
    tracer = None
    if telemetry_on:
        from repro_torch.telemetry import TelemetryCfg, configure_tracing
        tel_cfg = TelemetryCfg()
        if args.telemetry or args.trace_out:   # span tracing stays opt-in
            tracer = configure_tracing(True)
    tl_cfg = None
    if args.timeline_out:
        from repro_torch.telemetry import TimelineCfg
        tl_cfg = TimelineCfg()
    cfg = ServeCfg(cluster=cl, cold_start_s=args.cold_start)
    sc = ServingCluster(cfg, parse_policy(args.policy),
                        use_kernel=args.use_kernel, telemetry=tel_cfg,
                        timeline=tl_cfg, device=device)
    if tracer is not None:
        with tracer.span("serve.run", policy=args.policy,
                         workload=wname, load=args.load, n=args.n):
            out = sc.run(wl)
    else:
        out = sc.run(wl)
    s = summarize(out.response, wl.service, out.cold, out.rejected,
                  out.server_time, out.core_time, out.end_time)
    ka = lifecycle.keepalive if lifecycle else "legacy-inf"
    preset = lifecycle.coldstart if lifecycle else "scalar"
    fdesc = "homogeneous" if fleet is None else \
        f"{'explicit' if fleet.speed else fleet.preset}/{fleet.autoscale}"
    print(f"policy={args.policy} workload={wname} "
          f"load={args.load} keepalive={ka} coldstart={preset} "
          f"fleet={fdesc}")
    print(f"  slow p50/p99 = {s.slow_p50:.2f} / {s.slow_p99:.1f}")
    print(f"  lat  p50/p99 = {s.lat_p50:.2f}s / {s.lat_p99:.2f}s")
    print(f"  cold starts  = {100*s.cold_frac:.1f}%   "
          f"servers = {s.mean_servers:.2f}   rejected = {s.n_rejected}")
    if fleet is not None and fleet.autoscale != STATIC:
        print(f"  autoscale    : target p99 ≤ {fleet.target_p99:g}, "
              f"provisioned = {out.prov_core_s:.0f} core-s "
              f"(static fleet would be "
              f"{out.end_time * cl.n_workers * cl.cores:.0f})")
    if out.telemetry is not None:
        t = out.telemetry.summary()
        print(f"  telemetry    : sketch slow p50/p99 = "
              f"{t['slow_p50']:.2f} / {t['slow_p99']:.1f}  "
              f"cold={t['n_cold']} warm={t['n_warm']} "
              f"evict={t['n_evict']} reject={t['n_reject']}  "
              f"busy={t['busy_time_s']:.1f}s")
    if out.timeline is not None:
        ts = out.timeline.summary()
        csv_p = out.timeline.write_csv(args.timeline_out)
        om_p = out.timeline.write_openmetrics(args.timeline_out + ".om")
        if tracer is not None:
            out.timeline.emit_counters(tracer)
        print(f"  timeline     : {ts['n_windows']} windows of "
              f"{ts['window_s']:.2f}s, peak arrivals="
              f"{ts['arrivals_peak']}, {ts['n_events']} decision "
              f"events -> {csv_p} + {om_p}")
    if args.trace_out:
        tracer.export(args.trace_out)
        print(f"  trace        : {args.trace_out} "
              f"(load at https://ui.perfetto.dev)")


if __name__ == "__main__":
    main()
