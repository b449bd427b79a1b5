"""``repro_torch.telemetry`` against ``repro.telemetry`` on the CPU.

* The sketch: the edges bit-equal to the reference's; ``bin_index``
  (torch) equal to ``bin_index_np`` (the port's and the reference's) on
  random values, on the edges themselves, on their neighbours and out of
  range; the documented ≤ 2 % accuracy over heavy-tailed, bimodal and
  trace-replay draws; percentile reads equal to the reference's on the
  same counts.
* The state: the numpy updaters equal to the reference's over one random
  event sequence; ``TelemetryResult``'s pooled and sliced readers and its
  summary against the reference's on the same arrays; the port's engine
  counts exactly the post-warmup accepted completions;
  ``WarmupMismatchError`` from the port's summaries.
* Spans and manifest: the Chrome-trace export, the disabled tracer, the
  ``torch.profiler.record_function`` bridge, the wall split, the
  manifest's torch, CUDA and device fields.

Where JAX is not installed, the reference-side tests skip.
"""
import json

import numpy as np
import pytest
import torch

from repro_torch.core import (ClusterCfg, E_LL_PS, HERMES, WORKLOADS,
                              ms_trace, stack_workloads,
                              summarize_batch_sim, summarize_sim,
                              synth_workload)
from repro_torch.core.simulator import simulate, simulate_many
from repro_torch.telemetry import (N_BINS, TelemetryCfg, TelemetryResult,
                                   Tracer, WarmupMismatchError,
                                   bin_index_np, collect_manifest,
                                   configure_tracing, get_tracer,
                                   hist_edges, init_np, on_advance_np,
                                   on_complete_np, on_evict_np,
                                   on_place_np, on_reject_np, set_tracer,
                                   sketch_count, sketch_percentile, span,
                                   wall_split_from_aggregate,
                                   warmup_cutoff)
from repro_torch.telemetry import engine as tel_engine

try:
    import repro.telemetry as rt
except ImportError:     # no JAX installed: the reference tests skip
    rt = None

CLUSTER = ClusterCfg(n_workers=4, cores=3, capacity_factor=2)
TEL = TelemetryCfg(warmup_frac=0.1)


@pytest.fixture
def reference():
    if rt is None:
        pytest.skip("the JAX reference package is not installed here")


def _draws(kind, n=20000, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "lognormal":
        return rng.lognormal(mean=0.5, sigma=1.5, size=n)
    if kind == "bimodal":
        n_short = int(n * 0.6)
        return np.concatenate([
            rng.lognormal(mean=-2.0, sigma=0.4, size=n_short),
            rng.lognormal(mean=2.5, sigma=0.6, size=n - n_short)])
    wl = WORKLOADS["azure-bursty"](CLUSTER, 0.6, n, seed=seed)
    return np.asarray(wl.service, dtype=np.float64)


# -- the sketch --------------------------------------------------------------

def test_edges_bit_equal(reference):
    e = hist_edges()
    assert e.shape == (N_BINS + 1,) and e.dtype == np.float64
    assert e.tobytes() == rt.hist_edges().tobytes()
    assert np.all(np.diff(e) > 0)
    assert tel_engine.edges_for("cpu").numpy().tobytes() == e.tobytes()


def _probe_values():
    e = hist_edges()
    rng = np.random.default_rng(3)
    return np.concatenate([
        10.0 ** rng.uniform(-6, 8, 4000),            # random, in and out
        e, np.nextafter(e, 0.0), np.nextafter(e, np.inf),   # the edges
        [0.0, -1.0, 1e-300, 1e-9, 1e9, 1e300, np.inf, 1.0]])


@pytest.mark.parametrize("part", ["random", "edges", "out-of-range"])
def test_bin_index_matches_numpy(reference, part):
    x = _probe_values()
    x = {"random": x[:4000], "edges": x[4000:4000 + 3 * (N_BINS + 1)],
         "out-of-range": x[-8:]}[part]
    want = bin_index_np(x)
    np.testing.assert_array_equal(want, rt.bin_index_np(x))
    got = tel_engine.bin_index(torch.tensor(x), tel_engine.edges_for("cpu"))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.min() >= 0 and got.max() <= N_BINS - 1


def test_bins_at_the_ends():
    e = hist_edges()
    assert bin_index_np(np.array([0.0, 1e-9])).tolist() == [0, 0]
    assert bin_index_np(np.array([1e9])).tolist() == [N_BINS - 1]
    b = bin_index_np(np.array([1.0]))[0]
    assert e[b] <= 1.0 < e[b + 1]


@pytest.mark.parametrize("kind", ["lognormal", "bimodal", "azure-replay"])
@pytest.mark.parametrize("q", [50, 90, 99])
def test_sketch_percentile_accuracy(kind, q):
    x = _draws(kind)
    counts = np.bincount(bin_index_np(x), minlength=N_BINS)
    got = sketch_percentile(counts, q)
    want = float(np.percentile(x, q))
    assert abs(got - want) / want < 0.02
    assert sketch_count(counts) == x.size


@pytest.mark.parametrize("q", [1, 50, 90, 99, 99.9, 100])
def test_percentile_reads_match_reference(reference, q):
    rng = np.random.default_rng(int(q * 10))
    for counts in (rng.integers(0, 5, (3, N_BINS)),
                   np.eye(1, N_BINS, 0, dtype=np.int64)[0],
                   np.eye(1, N_BINS, N_BINS - 1, dtype=np.int64)[0] * 7):
        assert sketch_percentile(counts, q) == rt.sketch_percentile(counts,
                                                                    q)
        assert sketch_count(counts) == rt.sketch_count(counts)


def test_sketch_percentile_empty_is_nan():
    assert np.isnan(sketch_percentile(np.zeros(N_BINS, dtype=np.int64), 50))


# -- the state ---------------------------------------------------------------

def test_numpy_updaters_match_reference(reference):
    rng = np.random.default_rng(5)
    W, cut = 6, 40
    ours, theirs = init_np(W), rt.init_np(W)
    for k in range(400):
        ev = int(rng.integers(5))
        if ev == 0:
            args = (int(rng.integers(W)), bool(rng.integers(2)),
                    bool(rng.integers(2)))
            on_place_np(ours, *args)
            rt.on_place_np(theirs, *args)
        elif ev == 1:
            args = (float(rng.exponential()), rng.integers(0, 2, W),
                    rng.integers(0, 5, W), int(rng.integers(4)))
            on_advance_np(ours, *args)
            rt.on_advance_np(theirs, *args)
        elif ev == 2:
            args = (float(rng.lognormal()), float(rng.lognormal()), k, cut)
            on_complete_np(ours, *args)
            rt.on_complete_np(theirs, *args)
        elif ev == 3:
            on_evict_np(ours, 2)
            rt.on_evict_np(theirs, 2)
        else:
            on_reject_np(ours)
            rt.on_reject_np(theirs)
    assert sorted(ours) == sorted(theirs)
    for key in ours:
        assert np.asarray(ours[key]).tobytes() == \
            np.asarray(theirs[key]).tobytes(), key
    assert warmup_cutoff(1000, TEL) == rt.warmup_cutoff(1000, rt.TelemetryCfg(
        warmup_frac=0.1)) == 100


def _batched(seeds=(0, 1, 2), policy=E_LL_PS):
    wls = [ms_trace(CLUSTER, 0.6, 300, seed=s) for s in seeds]
    wb = stack_workloads(wls)
    return wb, simulate_many(policy, CLUSTER, wb, device="cpu",
                             telemetry=TEL)


def test_result_readers_match_reference(reference):
    """The port's readers over the port's arrays give what the
    reference's give over the same arrays: pooled percentiles, slices,
    ``rep`` and the summary."""
    wb, out = _batched()
    ours = out.telemetry
    fields = {f: getattr(ours, f) for f in (
        "slow_hist", "lat_hist", "n_cold", "n_warm", "n_evict", "n_reject",
        "busy_time", "depth_time", "qlen_time", "decisions")}
    theirs = rt.TelemetryResult.from_state(fields, rt.TelemetryCfg(0.1))
    for q in (50, 99):
        assert ours.slow_percentile(q) == theirs.slow_percentile(q)
        assert ours.lat_percentile(q) == theirs.lat_percentile(q)
    assert ours.summary() == theirs.summary()
    assert ours[1:3].summary() == theirs[1:3].summary()
    assert ours.rep(2).summary() == theirs.rep(2).summary()
    np.testing.assert_array_equal(ours[1:3].slow_hist, ours.slow_hist[1:3])
    np.testing.assert_array_equal(out[1:3].telemetry.slow_hist,
                                  ours.slow_hist[1:3])
    assert out.rep(1).telemetry.summary() == ours.rep(1).summary()
    assert np.isfinite(ours.slow_percentile(99))


def test_batch_pools_per_rep_runs():
    wb, out = _batched()
    for r in range(wb.n_reps):
        one = simulate_many(E_LL_PS, CLUSTER, stack_workloads(
            [ms_trace(CLUSTER, 0.6, 300, seed=r)]), device="cpu",
            telemetry=TEL).telemetry
        for f in ("slow_hist", "lat_hist", "decisions", "busy_time"):
            assert getattr(one, f)[0].tobytes() == \
                getattr(out.telemetry, f)[r].tobytes(), f
    np.testing.assert_array_equal(
        out.telemetry.slow_hist.sum(axis=0),
        sum(out.telemetry.rep(r).slow_hist for r in range(wb.n_reps)))


def test_counts_match_population():
    wl = synth_workload(CLUSTER, 0.8, 400, n_functions=5, hot_fraction=0.8,
                        seed=3)
    out = simulate(HERMES, CLUSTER, wl, device="cpu", telemetry=TEL)
    cut = int(wl.n * TEL.warmup_frac)
    accepted = int((~out.rejected)[cut:].sum())
    assert sketch_count(out.telemetry.slow_hist) == accepted
    assert sketch_count(out.telemetry.lat_hist) == accepted
    t = out.telemetry
    assert int(t.n_cold + t.n_warm + t.n_reject) == wl.n
    assert int(t.n_cold) == int(out.cold.sum())
    assert int(t.decisions.sum()) == int((~out.rejected).sum())


def test_summary_fields():
    wl = synth_workload(CLUSTER, 0.8, 250, n_functions=5, hot_fraction=0.8,
                        seed=0)
    s = simulate(E_LL_PS, CLUSTER, wl, device="cpu",
                 telemetry=TEL).telemetry.summary()
    for k in ("n_observed", "slow_p50", "slow_p99", "lat_p50_s",
              "lat_p99_s", "n_cold", "n_warm", "cold_frac", "n_evict",
              "n_reject", "busy_time_s", "qlen_time_s",
              "decision_max_frac"):
        assert k in s, k
    assert s["slow_p50"] >= 1.0 - 0.02


def test_warmup_mismatch_raises(reference):
    wb, out = _batched(seeds=(0,))
    summarize_batch_sim(out, wb, warmup_frac=0.1)
    with pytest.raises(WarmupMismatchError) as err:
        summarize_batch_sim(out, wb, warmup_frac=0.2)
    assert (err.value.engine_frac, err.value.summarize_frac) == (0.1, 0.2)
    assert str(err.value) == str(rt.WarmupMismatchError(0.1, 0.2))
    with pytest.raises(WarmupMismatchError):
        summarize_sim(out.rep(0), ms_trace(CLUSTER, 0.6, 300, seed=0),
                      warmup_frac=0.3)
    # no telemetry, no contract
    plain = simulate_many(E_LL_PS, CLUSTER, wb, device="cpu")
    summarize_batch_sim(plain, wb, warmup_frac=0.3)


# -- spans and manifest ------------------------------------------------------

def test_tracer_spans_export_chrome_trace(tmp_path):
    tr = Tracer(enabled=True)
    with tr.span("outer", mode="test"):
        with tr.span("inner"):
            pass
    tr.instant("mark")
    tr.event_at("task", 1.5, 0.25, tid=2, cold=True)
    tr.counter_at("n_on", 2.0, 3)
    path = tmp_path / "trace.json"
    tr.export(str(path))
    doc = json.loads(path.read_text())
    evs = doc["traceEvents"]
    names = [e["name"] for e in evs]
    assert "outer" in names and "inner" in names and "task" in names
    assert all(e["dur"] >= 0 for e in evs if e["ph"] == "X")
    task = next(e for e in evs if e["name"] == "task")
    assert task["ts"] == pytest.approx(1.5e6) \
        and task["dur"] == pytest.approx(0.25e6)
    agg = tr.aggregate()
    assert agg["outer"]["count"] == 1
    assert agg["outer"]["total_s"] >= agg["inner"]["total_s"]
    assert "task" not in agg


def test_disabled_tracer_records_nothing():
    tr = Tracer(enabled=False)
    with tr.span("x"):
        pass
    tr.instant("y")
    tr.event_at("z", 0.0, 1.0)
    assert tr.events == []


def test_torch_profiler_bridge():
    """With the bridge on, a span opens a ``record_function`` range, which
    a profiler sees."""
    tr = Tracer(enabled=True, torch_bridge=True)
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]) as prof:
        with tr.span("bridged"):
            torch.ones(4).sum()
    assert any(e.name == "bridged" for e in prof.events())
    assert [e["name"] for e in tr.events] == ["bridged"]


def test_process_tracer_and_span():
    old = get_tracer()
    try:
        tr = configure_tracing(True)
        with span("global"):
            pass
        assert get_tracer() is tr and tr.aggregate()["global"]["count"] == 1
    finally:
        set_tracer(old)


def test_wall_split_from_aggregate(reference):
    agg = {"engine.build": {"count": 2, "total_s": 1.0},
           "engine.first_run": {"count": 2, "total_s": 3.0},
           "engine.run": {"count": 10, "total_s": 5.0}}
    ws = wall_split_from_aggregate(agg)
    assert ws == rt.wall_split_from_aggregate(agg)
    assert ws["compile_heavy_s"] == pytest.approx(4.0)


def test_manifest_collects():
    m = collect_manifest(seeds={"base": 0}, args={"mode": "test"})
    d = m.as_dict()
    for k in ("git_sha", "python", "torch_version", "cuda_version",
              "numpy_version", "devices", "started_at", "seeds", "args"):
        assert k in d, k
    assert "jax_version" not in d
    assert d["torch_version"] == torch.__version__
    assert d["seeds"] == {"base": 0}
    if not torch.cuda.is_available():
        assert d["devices"] == []


def test_result_from_engine_state_slices_the_dropped_bin():
    st = tel_engine.init_state(2, 3, "cpu")
    assert st["slow_hist"].shape == (2, N_BINS + 1)
    st["slow_hist"][:, N_BINS] = 9          # the dropped bin
    res = tel_engine.result_of(st, TEL)
    assert isinstance(res, TelemetryResult)
    assert res.slow_hist.shape == (2, N_BINS) and res.slow_hist.sum() == 0
