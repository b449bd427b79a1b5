"""The serving platform (``repro_torch.serving.engine``) and its launcher
on the CPU.

* ``ServingCluster`` with ``device="cpu"`` against the reference's
  ``repro.serving.engine.ServingCluster`` on the same workload: the nine
  early-binding balancers (E/<B>/PS), L/LL/FCFS, E/LL/SRPT and E/H/FCFS,
  then under a lifecycle (FIXED_TTL; HYBRID_HIST with a budget and the
  ``aws-lambda`` preset), telemetry, a ``two-gen`` fleet under
  ``TARGET_P99``, a timeline, straggler re-dispatch and the health mask:
  integer arrays equal, floats within 1e-9, the telemetry's and the
  timeline's integer planes equal.
* ``use_kernel=True`` equal to ``False`` (the reference's
  ``tests/test_serving.py`` check) and its named refusal of a balancer
  without a kernel; the CPU run launches no kernel; the default device is
  the card.
* ``python -m repro_torch.launch.serve``'s printed lines and written
  timeline files equal to ``python -m repro.launch.serve``'s for two flag
  sets; ``--backend models``'s lines equal to the reference's apart from
  the measured milliseconds, and its named refusal of an unknown
  ``--keepalive``.

Workloads come from the workload generators' seeds.  Where JAX is not
installed, the reference-side tests skip.  The last test runs only where
a card is present.
"""
import contextlib
import io
import sys

import numpy as np
import pytest
import torch

from repro_torch.core import (ClusterCfg, FleetCfg, LifecycleCfg, ms_trace,
                              parse_policy, synth_workload)
from repro_torch.device import NoCudaDeviceError
from repro_torch.kernels.hermes_select import kernel as hermes_kernel
from repro_torch.launch import serve
from repro_torch.serving.engine import ServeCfg, ServingCluster
from repro_torch.telemetry import (TelemetryCfg, TimelineCfg, get_tracer,
                                   set_tracer)

try:
    import repro.core as rc
    import repro.fleet as rf
    import repro.lifecycle as rl
    import repro.launch.serve as ref_serve
    from repro.serving import engine as ref_engine
    from repro.telemetry import TelemetryCfg as JaxTelemetryCfg
    from repro.telemetry import TimelineCfg as JaxTimelineCfg
    from repro.telemetry import get_tracer as ref_get_tracer
    from repro.telemetry import set_tracer as ref_set_tracer
except ImportError:     # no JAX installed: the reference tests skip
    rc = None

SMALL = dict(n_workers=4, cores=3, capacity_factor=2)
N = 300
TL = TimelineCfg(n_windows=16, coarse_bins=48, max_events=64)
POLICIES = ("E/H/PS", "E/LL/PS", "E/LOC/PS", "E/R/PS", "E/JSQ2/PS",
            "E/RR/PS", "E/HIKU/PS", "E/DD/PS", "E/SWARM/PS", "L/LL/FCFS",
            "E/LL/SRPT", "E/H/FCFS")
#: id -> (cluster extras, ServeCfg extras, telemetry, timeline)
OPTIONS = {
    "fixed-ttl": (dict(lifecycle=("FIXED_TTL", 2.0, 0, "scalar")), {},
                  False, True),
    "hybrid-budget-preset": (dict(lifecycle=("HYBRID_HIST", 2.0, 2,
                                             "aws-lambda")), {}, True, True),
    "telemetry": ({}, {}, True, False),
    "two-gen-target-p99": (dict(fleet=dict(
        preset="two-gen", autoscale="TARGET_P99", target_p99=3.0,
        min_workers=2, cooldown_s=1.0)), {}, True, True),
    "straggler-health": ({}, dict(speeds=(0.2, 1.0, 1.0, 1.0),
                                  redispatch_deadline_s=1.0,
                                  redispatch_frac=0.5, health_aware=True,
                                  detect_after_s=5.0), False, True),
}
INTS = ("cold", "rejected", "worker", "redispatched")
FLOATS = ("response", "server_time", "core_time", "end_time",
          "prov_core_s")
TL_INTS = ("mode", "arrivals", "n_cold", "n_warm", "n_evict", "n_reject",
           "slow_hist", "lat_hist", "n_on", "ev_kind", "ev_val", "ev_count")
TL_FLOATS = ("window_s", "busy_time", "qlen_time", "prov_core", "ev_t",
             "ev_p99")
TEL_INTS = ("slow_hist", "lat_hist", "n_cold", "n_warm", "n_evict",
            "n_reject", "decisions")


@pytest.fixture
def reference():
    if rc is None:
        pytest.skip("the JAX reference package is not installed here")


def _clusters(extra):
    kw, jkw = dict(SMALL), dict(SMALL)
    if "lifecycle" in extra:
        kw["lifecycle"] = LifecycleCfg(*extra["lifecycle"])
        jkw["lifecycle"] = rl.LifecycleCfg(*extra["lifecycle"])
    if "fleet" in extra:
        kw["fleet"] = FleetCfg(**extra["fleet"])
        jkw["fleet"] = rf.FleetCfg(**extra["fleet"])
    return ClusterCfg(**kw), rc.ClusterCfg(**jkw)


def _both(policy, extra=None, scfg=None, tel=False, tl=False, load=0.9,
          seed=2):
    """The port's run on the CPU and the reference's, same inputs."""
    cl, jcl = _clusters(extra or {})
    wl = synth_workload(cl, load, N, n_functions=5, seed=seed)
    jwl = rc.synth_workload(jcl, load, N, n_functions=5, seed=seed)
    assert np.array_equal(wl.arrival, jwl.arrival)
    ours = ServingCluster(ServeCfg(cluster=cl, **(scfg or {})), policy,
                          telemetry=TelemetryCfg() if tel else None,
                          timeline=TL if tl else None,
                          device="cpu").run(wl)
    theirs = ref_engine.ServingCluster(
        ref_engine.ServeCfg(cluster=jcl, **(scfg or {})),
        rc.parse_policy(policy),
        telemetry=JaxTelemetryCfg() if tel else None,
        timeline=JaxTimelineCfg(*TL) if tl else None).run(jwl)
    return ours, theirs


def _assert_same(ours, theirs):
    for f in INTS:
        np.testing.assert_array_equal(getattr(ours, f), getattr(theirs, f),
                                      err_msg=f)
    for f in FLOATS:
        np.testing.assert_allclose(getattr(ours, f), getattr(theirs, f),
                                   rtol=1e-9, atol=1e-9, err_msg=f)
    assert (ours.n_cold, ours.n_redispatch) == \
        (theirs.n_cold, theirs.n_redispatch)
    assert (ours.timeline is None) == (theirs.timeline is None)
    if ours.timeline is not None:
        for f in TL_INTS:
            np.testing.assert_array_equal(getattr(ours.timeline, f),
                                          getattr(theirs.timeline, f),
                                          err_msg=f)
        for f in TL_FLOATS:
            np.testing.assert_allclose(getattr(ours.timeline, f),
                                       getattr(theirs.timeline, f),
                                       rtol=1e-9, atol=1e-9, err_msg=f)
    assert (ours.telemetry is None) == (theirs.telemetry is None)
    if ours.telemetry is not None:
        for f in TEL_INTS:
            np.testing.assert_array_equal(getattr(ours.telemetry, f),
                                          getattr(theirs.telemetry, f),
                                          err_msg=f)


@pytest.mark.parametrize("policy", POLICIES)
def test_platform_matches_the_reference(reference, policy):
    ours, theirs = _both(policy, tl=True)
    _assert_same(ours, theirs)
    assert ours.timeline.summary() == theirs.timeline.summary()


@pytest.mark.parametrize("option", OPTIONS)
@pytest.mark.parametrize("policy", ("E/H/PS", "E/LL/PS", "E/DD/PS",
                                    "E/HIKU/PS"))
def test_platform_options_match_the_reference(reference, option, policy):
    extra, scfg, tel, tl = OPTIONS[option]
    ours, theirs = _both(policy, extra, scfg, tel, tl, seed=3)
    _assert_same(ours, theirs)
    if option == "straggler-health":
        assert ours.n_redispatch > 0
    if option == "two-gen-target-p99":
        assert int(ours.timeline.ev_count) > 0


def test_use_kernel_matches_the_balancer_path():
    cl = ClusterCfg(n_workers=4, cores=4)
    cfg = ServeCfg(cluster=cl, cold_start_s=0.2)
    wl = ms_trace(cl, 0.5, 400, seed=3)
    before = hermes_kernel.hermes_select_batch.launches
    a = ServingCluster(cfg, parse_policy("E/H/PS"), use_kernel=False,
                       device="cpu").run(wl)
    b = ServingCluster(cfg, parse_policy("E/H/PS"), use_kernel=True,
                       device="cpu").run(wl)
    # the CPU runs the plain versions: no launch
    assert hermes_kernel.hermes_select_batch.launches == before
    np.testing.assert_allclose(np.nan_to_num(a.response, nan=-1),
                               np.nan_to_num(b.response, nan=-1),
                               rtol=1e-9, atol=1e-9)
    np.testing.assert_array_equal(a.worker, b.worker)
    life = cl._replace(lifecycle=LifecycleCfg("FIXED_TTL", 1.0, 1,
                                              "scalar"))
    wl = ms_trace(life, 0.5, 300, seed=4)
    a, b = (ServingCluster(ServeCfg(cluster=life), parse_policy("E/H/PS"),
                           use_kernel=k, device="cpu").run(wl)
            for k in (False, True))
    np.testing.assert_array_equal(a.cold, b.cold)
    np.testing.assert_array_equal(a.worker, b.worker)


def test_use_kernel_refuses_a_balancer_without_one(reference):
    cfg = ServeCfg(cluster=ClusterCfg(**SMALL))
    for name in ("E/LL/PS", "L/LL/FCFS"):
        with pytest.raises(ValueError, match="no batched kernel") as ours:
            ServingCluster(cfg, parse_policy(name), use_kernel=True,
                           device="cpu")
        with pytest.raises(ValueError) as theirs:
            ref_engine.ServingCluster(
                ref_engine.ServeCfg(cluster=rc.ClusterCfg(**SMALL)),
                rc.parse_policy(name), use_kernel=True)
        assert str(ours.value) == str(theirs.value)


def test_named_errors_of_the_autoscaler():
    cl = ClusterCfg(**SMALL, fleet=FleetCfg(autoscale="TARGET_P99"))
    wl = synth_workload(cl, 0.5, 50, n_functions=5, seed=1)
    with pytest.raises(ValueError, match="requires early binding"):
        ServingCluster(ServeCfg(cluster=cl), parse_policy("L/LL/FCFS"),
                       telemetry=TelemetryCfg(), device="cpu").run(wl)
    with pytest.raises(ValueError, match="telemetry"):
        ServingCluster(ServeCfg(cluster=cl), parse_policy("E/H/PS"),
                       device="cpu").run(wl)


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    with pytest.raises(NoCudaDeviceError):
        ServingCluster(ServeCfg())


def _printed(fn):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        fn()
    return out.getvalue()


@pytest.mark.parametrize("flags", [
    ["--policy", "E/H/PS", "--load", "0.6", "-n", "400", "--workers", "4",
     "--cores", "3"],
    ["--workload", "azure-diurnal", "--load", "0.7", "-n", "400",
     "--keepalive", "HYBRID_HIST", "--ttl", "30", "--cold-start-preset",
     "aws-lambda", "--autoscale", "TARGET_P99", "--target-p99", "3",
     "--min-workers", "2", "--cooldown", "2", "--telemetry"],
], ids=["hermes", "diurnal-lifecycle-autoscale"])
def test_launcher_prints_the_reference_lines(reference, monkeypatch,
                                             tmp_path, flags):
    path = str(tmp_path / "tl.csv")
    flags = [*flags, "--timeline-out", path]
    tracers = (get_tracer(), ref_get_tracer())
    try:
        monkeypatch.setattr(sys, "argv", ["serve", *flags])
        theirs = _printed(ref_serve.main)
        files = (open(path).read(), open(path + ".om").read())
        ours = _printed(lambda: serve.main(flags, device="cpu"))
    finally:
        set_tracer(tracers[0])
        ref_set_tracer(tracers[1])
    assert ours == theirs
    assert (open(path).read(), open(path + ".om").read()) == files
    assert "timeline     : 64 windows" in ours


def _without_ms(text):
    """Each line without its last field, the measured milliseconds."""
    return [line.rsplit(None, 1)[0] for line in text.splitlines()]


@pytest.mark.parametrize("flags", [[], ["--keepalive", "FIXED_TTL",
                                        "--ttl", "30"]],
                         ids=["legacy", "fixed-ttl"])
def test_launcher_models_backend_prints_the_reference_lines(
        reference, monkeypatch, flags):
    """``--backend models --requests 4``: the reference's registrations
    (olmo-tiny, rwkv-tiny) behind the Hermes frontend, the same request,
    function, worker and cold/warm on every line."""
    flags = ["--backend", "models", "--requests", "4", *flags]
    monkeypatch.setattr(sys, "argv", ["serve", *flags])
    theirs = _printed(ref_serve.main)
    ours = _printed(lambda: serve.main(flags, device="cpu"))
    assert len(ours.splitlines()) == 4
    assert _without_ms(ours) == _without_ms(theirs)
    assert _without_ms(ours)[:2] == ["req  0 olmo-tiny  worker=0 COLD",
                                     "req  1 rwkv-tiny  worker=0 COLD"]
    for line in ours.splitlines():
        assert line.endswith("ms") and float(line.split()[-1][:-2]) > 0


def test_launcher_refuses_the_models_backend():
    """``--backend models`` runs now (its lines:
    ``test_launcher_models_backend_prints_the_reference_lines``); it
    refuses a keep-alive the lifecycle registry does not know, with the
    registry's named error, before it builds anything."""
    with pytest.raises(ValueError, match="NOPE"):
        serve.main(["--backend", "models", "--keepalive", "NOPE"],
                   device="cpu")


def test_card_dispatch_launches_once_per_arrival():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    cl = ClusterCfg(**SMALL)
    wl = synth_workload(cl, 0.9, N, n_functions=5, seed=2)
    for policy, n_launch in (("E/H/PS", N), ("E/LL/PS", 0),
                             ("E/DD/PS", 0)):
        before = hermes_kernel.hermes_select_batch.launches
        card = ServingCluster(ServeCfg(cluster=cl), parse_policy(policy),
                              timeline=TL).run(wl)
        assert hermes_kernel.hermes_select_batch.launches - before == \
            n_launch
        cpu = ServingCluster(ServeCfg(cluster=cl), parse_policy(policy),
                             timeline=TL, device="cpu").run(wl)
        for f in INTS + FLOATS:
            assert np.asarray(getattr(card, f)).tobytes() == \
                np.asarray(getattr(cpu, f)).tobytes(), f
