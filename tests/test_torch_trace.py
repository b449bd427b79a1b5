"""Port trace replay (``repro_torch.trace``) against ``repro.trace``.

Both packages run in this one process on the same arguments, so numpy's
float64 ``exp``/``log`` take the same path in both: every array must be
bit-equal.

* ``norm_ppf`` and the percentile columns;
* ``synthesize_trace`` and ``replay_trace`` for every scenario (the four
  synthetic presets and the bundled fixture) × loads {None, 0.5, 0.9} ×
  seeds {0, 1} × N ∈ {300, 5000} (N = 5000 tiles the trace);
* the catalog's five ``azure-*`` workloads on the small and testbed
  clusters, ``resample_workloads`` on a mixed list, ``per_minute_counts``;
* the CSV schema: byte-identical files from both writers, a round trip,
  and the malformed files of ``tests/test_trace.py`` raising the same
  exception with the same message;
* the digest cache's hit/miss counts, the fixture CSVs (same SHA-256 as
  the reference's) and the lazy package surface.
"""
import dataclasses
import hashlib
import sys

import numpy as np
import pytest

import repro.core as rc
import repro.trace as rtrace
from repro.trace import cache as rcache
from repro.trace import catalog as rcatalog
from repro.trace import replay as rreplay
from repro.trace import schema as rschema
from repro.trace import synth_trace as rsynth

import repro_torch.core as pc
import repro_torch.trace as ptrace
from repro_torch.trace import cache as pcache
from repro_torch.trace import catalog as pcatalog
from repro_torch.trace import replay as preplay
from repro_torch.trace import schema as pschema
from repro_torch.trace import synth_trace as psynth

FIELDS = ("arrival", "func", "service", "u_lb", "func_home")
CLUSTERS = {"small": (pc.PAPER_SMALL, rc.PAPER_SMALL),
            "testbed": (pc.PAPER_TESTBED, rc.PAPER_TESTBED)}
SCENARIOS = (*sorted(rsynth.SCENARIOS), "fixture")
AZURE = ("azure-diurnal", "azure-bursty", "azure-cold-heavy",
         "azure-flash-crowd", "azure-fixture")


def _same(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


def _same_workload(mine, ref):
    for f in FIELDS:
        _same(getattr(mine, f), getattr(ref, f))
    assert (mine.n_functions, mine.load, mine.name) == \
        (ref.n_functions, ref.load, ref.name)


def _same_trace(mine, ref):
    assert (mine.minutes, mine.n_functions) == (ref.minutes, ref.n_functions)
    _same(mine.counts_matrix(), ref.counts_matrix())
    for a, b in zip(mine.functions, ref.functions):
        assert (a.key, a.trigger, a.count) == (b.key, b.trigger, b.count)
        assert a.duration_ms == b.duration_ms
        assert (a.average_ms, a.minimum_ms, a.maximum_ms) == \
            (b.average_ms, b.minimum_ms, b.maximum_ms)


def _traces(scenario, seed):
    """(port trace, reference trace) for a preset (2000 invocations, so
    N = 5000 tiles) or the bundled fixture (read by each package from
    its own copy)."""
    if scenario == "fixture":
        return (pschema.load_trace(pcatalog.FIXTURE_INVOCATIONS,
                                   pcatalog.FIXTURE_DURATIONS),
                rschema.load_trace(rcatalog.FIXTURE_INVOCATIONS,
                                   rcatalog.FIXTURE_DURATIONS))
    kw = dict(total_invocations=2000, seed=seed)
    return (psynth.synthesize_trace(scenario, **kw),
            rsynth.synthesize_trace(scenario, **kw))


# ---------------------------------------------------------------- schema


@pytest.mark.parametrize("p", [1e-6, 1e-3, 0.01, 0.02425, 0.25, 0.5, 0.75,
                               0.975, 0.99, 1 - 1e-3])
def test_norm_ppf_equal(p):
    assert pschema.norm_ppf(p) == rschema.norm_ppf(p)
    # the reference test's classic z-scores
    if p in (0.5, 0.975, 0.99, 0.01):
        want = {0.5: 0.0, 0.975: 1.959964, 0.99: 2.326348, 0.01: -2.326348}
        assert pschema.norm_ppf(p) == pytest.approx(want[p], abs=1e-5)


def test_norm_ppf_refuses_what_the_reference_refuses():
    for p in (0.0, 1.0, -0.5):
        with pytest.raises(ValueError) as mine:
            pschema.norm_ppf(p)
        with pytest.raises(ValueError) as ref:
            rschema.norm_ppf(p)
        assert str(mine.value) == str(ref.value)


def test_constants_and_percentile_columns_equal():
    assert (pschema.AZURE_MU, pschema.AZURE_SIGMA) == \
        (rschema.AZURE_MU, rschema.AZURE_SIGMA)
    assert pschema.AZURE_MU is pc.AZURE_MU   # one source: core.workload
    assert pschema.DURATION_COLUMNS == rschema.DURATION_COLUMNS
    assert pschema.INVOCATION_FIXED_COLUMNS == \
        rschema.INVOCATION_FIXED_COLUMNS
    for mu, sigma in ((-0.4, 0.8), (pschema.AZURE_MU, pschema.AZURE_SIGMA),
                      (1.2, 0.0)):
        assert pschema.lognormal_percentiles_ms(mu, sigma) == \
            rschema.lognormal_percentiles_ms(mu, sigma)


def _csv_pair(tmp_path, writer, trace, tag):
    inv = str(tmp_path / f"{tag}_inv.csv")
    dur = str(tmp_path / f"{tag}_dur.csv")
    writer(trace, inv, dur)
    return inv, dur


def _read(path):
    with open(path, "rb") as fh:
        return fh.read()


@pytest.mark.parametrize("scenario", sorted(rsynth.SCENARIOS))
def test_csv_files_byte_equal_and_round_trip(tmp_path, scenario):
    mine, ref = (m.synthesize_trace(scenario, n_functions=5, minutes=30,
                                    total_invocations=500, seed=11)
                 for m in (psynth, rsynth))
    _same_trace(mine, ref)
    p = _csv_pair(tmp_path, psynth.write_trace_csvs, mine, "port")
    r = _csv_pair(tmp_path, rsynth.write_trace_csvs, ref, "ref")
    assert _read(p[0]) == _read(r[0]) and _read(p[1]) == _read(r[1])
    # each package reads the other's files back to the same trace
    _same_trace(pschema.load_trace(*r), mine)
    _same_trace(rschema.load_trace(*p), mine)


def _break_count_cell(line: str, value: str) -> str:
    cells = line.split(",")
    cells[-1] = value
    return ",".join(cells)


def _swap_p50_p75(lines):
    cells = lines[1].split(",")
    a = rschema.DURATION_COLUMNS.index("percentile_Average_50")
    b = rschema.DURATION_COLUMNS.index("percentile_Average_75")
    cells[a], cells[b] = cells[b], cells[a]
    return [lines[0], ",".join(cells)] + lines[2:]


#: (file broken, how): tests/test_trace.py's malformed files, and a few
#: more of the checks ``read_durations`` makes
BREAKERS = {
    "header": ("inv", lambda l: [l[0].replace("Trigger", "Trigr")] + l[1:]),
    "contiguous": ("inv", lambda l: [l[0].replace(",3,", ",9,", 1)] + l[1:]),
    "negative": ("inv", lambda l: [l[0], _break_count_cell(l[1], "-3")]
                 + l[2:]),
    "non-integer": ("inv", lambda l: [l[0], _break_count_cell(l[1], "x")]
                    + l[2:]),
    "duplicate": ("inv", lambda l: l + [l[1]]),
    "short-row": ("inv", lambda l: [l[0], l[1].rsplit(",", 1)[0]] + l[2:]),
    "empty": ("inv", lambda l: []),
    "non-decreasing": ("dur", _swap_p50_p75),
    "dur-header": ("dur", lambda l: [l[0].replace("Average", "Avg", 1)]
                   + l[1:]),
    "dur-numeric": ("dur", lambda l: [l[0], _break_count_cell(l[1], "y")]
                    + l[2:]),
    "dur-duplicate": ("dur", lambda l: l + [l[1]]),
    "no-duration-row": ("dur", lambda l: l[:-1]),
}


@pytest.mark.parametrize("case", BREAKERS)
def test_malformed_files_raise_the_same_error(tmp_path, case):
    which, breaker = BREAKERS[case]
    trace = rsynth.synthesize_trace("diurnal", n_functions=3, minutes=10,
                                    total_invocations=200, seed=0)
    inv, dur = _csv_pair(tmp_path, rsynth.write_trace_csvs, trace, "ok")
    src = inv if which == "inv" else dur
    broken = tmp_path / "broken.csv"
    broken.write_text("\n".join(breaker(_read(src).decode().splitlines()))
                      + "\n")
    args = (str(broken), dur) if which == "inv" else (inv, str(broken))
    with pytest.raises(ValueError) as mine:
        pschema.load_trace(*args)
    with pytest.raises(ValueError) as ref:
        rschema.load_trace(*args)
    assert type(mine.value) is type(ref.value)
    assert str(mine.value) == str(ref.value)


def test_missing_durations_fall_back_alike(tmp_path):
    trace = rsynth.synthesize_trace("diurnal", n_functions=3, minutes=10,
                                    total_invocations=200, seed=0)
    inv, dur = _csv_pair(tmp_path, rsynth.write_trace_csvs, trace, "ok")
    short = tmp_path / "short_dur.csv"
    short.write_text("\n".join(_read(dur).decode().splitlines()[:-1]) + "\n")
    mine = pschema.load_trace(inv, str(short), allow_missing_durations=True)
    ref = rschema.load_trace(inv, str(short), allow_missing_durations=True)
    _same_trace(mine, ref)
    assert mine.functions[-1].duration_ms == \
        pschema.lognormal_percentiles_ms(pc.AZURE_MU, pc.AZURE_SIGMA)


def test_fixture_files_are_the_references():
    for mine, ref in ((pcatalog.FIXTURE_INVOCATIONS,
                       rcatalog.FIXTURE_INVOCATIONS),
                      (pcatalog.FIXTURE_DURATIONS,
                       rcatalog.FIXTURE_DURATIONS)):
        assert mine != ref      # the port reads its own copy
        assert hashlib.sha256(_read(mine)).hexdigest() == \
            hashlib.sha256(_read(ref)).hexdigest()
        assert pcache.file_digest(mine) == rcache.file_digest(ref)


def test_write_fixture_regenerates_the_bundled_files(tmp_path):
    inv, dur = psynth.write_fixture(str(tmp_path))
    assert _read(inv) == _read(pcatalog.FIXTURE_INVOCATIONS)
    assert _read(dur) == _read(pcatalog.FIXTURE_DURATIONS)


# ---------------------------------------------------------------- synth


@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("scenario", sorted(rsynth.SCENARIOS))
def test_synthesize_trace_equal(scenario, seed):
    for kw in ({}, dict(n_functions=9, minutes=45, total_invocations=800)):
        _same_trace(psynth.synthesize_trace(scenario, seed=seed, **kw),
                    rsynth.synthesize_trace(scenario, seed=seed, **kw))
    assert psynth.SCENARIOS == {k: psynth.ScenarioCfg(*dataclasses.astuple(v))
                                for k, v in rsynth.SCENARIOS.items()}


def test_synthesize_trace_refuses_alike():
    for args, kw in ((("nope",), {}), (("diurnal",), dict(minutes=0))):
        with pytest.raises(ValueError) as mine:
            psynth.synthesize_trace(*args, **kw)
        with pytest.raises(ValueError) as ref:
            rsynth.synthesize_trace(*args, **kw)
        assert str(mine.value) == str(ref.value)


# ---------------------------------------------------------------- replay


@pytest.mark.parametrize("n", [300, 5000])
@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("load", [None, 0.5, 0.9])
@pytest.mark.parametrize("scenario", SCENARIOS)
def test_replay_trace_equal(scenario, load, seed, n):
    mine_t, ref_t = _traces(scenario, seed)
    _same_trace(mine_t, ref_t)
    mine = preplay.replay_trace(mine_t, pc.PAPER_TESTBED, load=load,
                                n_arrivals=n, seed=seed)
    ref = rreplay.replay_trace(ref_t, rc.PAPER_TESTBED, load=load,
                               n_arrivals=n, seed=seed)
    _same_workload(mine, ref)
    assert mine.n == n
    if n == 5000:           # tiled: the trace holds fewer invocations
        assert mine_t.total_invocations < n


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_replay_verbatim_and_round_trip(scenario):
    """``load=None`` and no ``n_arrivals``: the trace once, in real time;
    ``per_minute_counts`` gives the trace's count matrix back."""
    mine_t, ref_t = _traces(scenario, 3)
    mine = preplay.replay_trace(mine_t, pc.PAPER_SMALL, seed=3)
    ref = rreplay.replay_trace(ref_t, rc.PAPER_SMALL, seed=3)
    _same_workload(mine, ref)
    counts = preplay.per_minute_counts(mine, mine_t.n_functions,
                                       mine_t.minutes)
    _same(counts, rreplay.per_minute_counts(ref, ref_t.n_functions,
                                            ref_t.minutes))
    _same(counts, mine_t.counts_matrix())


def test_per_minute_counts_fold_tiled_replays():
    mine_t, ref_t = _traces("bursty", 5)
    mine = preplay.replay_trace(mine_t, pc.PAPER_SMALL, n_arrivals=4500,
                                seed=2)
    ref = rreplay.replay_trace(ref_t, rc.PAPER_SMALL, n_arrivals=4500,
                               seed=2)
    for minute_s in (60.0, 30.0):
        _same(preplay.per_minute_counts(mine, mine_t.n_functions,
                                        mine_t.minutes, minute_s=minute_s),
              rreplay.per_minute_counts(ref, ref_t.n_functions,
                                        ref_t.minutes, minute_s=minute_s))


def test_replay_edge_cases_alike():
    """The all-zero-percentile fallback, the ``max_service`` clip, the
    least-squares fit, and the named errors."""
    mine_t, ref_t = _traces("diurnal", 6)

    def zero_first(t):
        f0 = t.functions[0]
        return dataclasses.replace(t, functions=(dataclasses.replace(
            f0, duration_ms={p: 0.0 for p in f0.duration_ms}),
            *t.functions[1:]))

    _same_workload(
        preplay.replay_trace(zero_first(mine_t), pc.PAPER_SMALL, seed=1,
                             max_service=2.0, n_arrivals=900),
        rreplay.replay_trace(zero_first(ref_t), rc.PAPER_SMALL, seed=1,
                             max_service=2.0, n_arrivals=900))
    for fn in mine_t.functions:
        assert preplay.fit_lognormal_from_percentiles(fn.duration_ms) == \
            rreplay.fit_lognormal_from_percentiles(fn.duration_ms)
    for pct in ({50: 120.0}, {1: 5.0, 25: 5.0, 99: 5.0}):
        assert preplay.fit_lognormal_from_percentiles(pct) == \
            rreplay.fit_lognormal_from_percentiles(pct)

    def empty(t):
        return dataclasses.replace(t, functions=tuple(
            dataclasses.replace(f, counts=np.zeros_like(f.counts))
            for f in t.functions))

    for call in (
            lambda m, t, cl: m.replay_trace(empty(t), cl),
            lambda m, t, cl: m.replay_trace(t, cl, n_arrivals=0),
            lambda m, t, cl: m.replay_trace(t, cl, load=-1.0),
            lambda m, t, cl: m.fit_lognormal_from_percentiles({50: 0.0})):
        with pytest.raises(ValueError) as mine:
            call(preplay, mine_t, pc.PAPER_SMALL)
        with pytest.raises(ValueError) as ref:
            call(rreplay, ref_t, rc.PAPER_SMALL)
        assert str(mine.value) == str(ref.value)


# ---------------------------------------------------------------- catalog


@pytest.mark.parametrize("n", [300, 2000])
@pytest.mark.parametrize("load", [0.3, 0.9])
@pytest.mark.parametrize("cluster", CLUSTERS)
@pytest.mark.parametrize("name", AZURE)
def test_catalog_workloads_equal(name, cluster, load, n):
    mine_cl, ref_cl = CLUSTERS[cluster]
    for seed in (0, 1):
        mine = pcatalog.TRACE_SCENARIOS[name](mine_cl, load, n, seed)
        ref = rcatalog.TRACE_SCENARIOS[name](ref_cl, load, n, seed)
        _same_workload(mine, ref)
        assert mine.name == name and mine.n == n


def test_workloads_hold_the_trace_scenarios():
    assert tuple(pcatalog.TRACE_SCENARIOS) == tuple(rcatalog.TRACE_SCENARIOS)
    assert set(AZURE) == set(pcatalog.TRACE_SCENARIOS)
    for name in AZURE:
        assert pc.WORKLOADS[name] is pcatalog.TRACE_SCENARIOS[name]
    assert set(pc.WORKLOADS) <= set(rc.WORKLOADS)
    assert pcatalog._REPLAY_SEED_OFFSET == rcatalog._REPLAY_SEED_OFFSET
    assert pcatalog.DATA_DIR.endswith("repro_torch/trace/data")


def _mixed(core, load, n, seed):
    return [core.WORKLOADS[name](core.PAPER_TESTBED, load, n, seed)
            for name in AZURE]


@pytest.mark.parametrize("n", [None, 250])
def test_resample_workloads_mixed(n):
    mine = preplay.resample_workloads(_mixed(pc, 0.7, 300, 1), n=n)
    ref = rreplay.resample_workloads(_mixed(rc, 0.7, 300, 1), n=n)
    for f in FIELDS:
        _same(getattr(mine, f), getattr(ref, f))
    assert (mine.n_functions, mine.loads, mine.names) == \
        (ref.n_functions, ref.loads, ref.names)
    assert mine.n_functions == 60 and mine.n == (n or 300)
    # widened homes: worker 0 for the ids a scenario does not have
    fixture = AZURE.index("azure-fixture")
    assert (mine.func_home[fixture, 12:] == 0).all()
    assert isinstance(mine, pc.WorkloadBatch)


def test_resample_workloads_refuses_alike():
    for args, kw in (([], {}), (_mixed(pc, 0.7, 300, 1), dict(n=301)),
                     (_mixed(pc, 0.7, 300, 1), dict(n=0))):
        with pytest.raises(ValueError) as mine:
            preplay.resample_workloads(args, **kw)
        ref_args = [] if not args else _mixed(rc, 0.7, 300, 1)
        with pytest.raises(ValueError) as ref:
            rreplay.resample_workloads(ref_args, **kw)
        assert str(mine.value) == str(ref.value)


# ---------------------------------------------------------------- cache


def _cache_walk(cache, synth, tmp_path, tag):
    cache.clear_trace_cache()
    trace = synth.synthesize_trace("diurnal", n_functions=3, minutes=10,
                                   total_invocations=300, seed=4)
    inv, dur = _csv_pair(tmp_path, synth.write_trace_csvs, trace, tag)
    a = cache.load_trace_cached(inv, dur)
    hit = cache.load_trace_cached(inv, dur) is a
    copy = tmp_path / f"{tag}_copy.csv"
    copy.write_bytes(_read(inv))
    renamed = cache.load_trace_cached(str(copy), dur) is a
    synth.write_trace_csvs(synth.synthesize_trace(
        "diurnal", n_functions=3, minutes=10, total_invocations=300, seed=9),
        inv, dur)
    rewritten = cache.load_trace_cached(inv, dur) is not a
    for i in range(cache.TRACE_CACHE_MAX + 2):   # LRU bound
        t = synth.synthesize_trace("bursty", n_functions=2, minutes=5,
                                   total_invocations=50, seed=100 + i)
        cache.load_trace_cached(*_csv_pair(tmp_path, synth.write_trace_csvs,
                                           t, f"{tag}{i}"))
    stats = cache.trace_cache_stats()
    cache.clear_trace_cache()
    return (hit, renamed, rewritten), stats


def test_cache_counts_equal(tmp_path):
    mine = _cache_walk(pcache, psynth, tmp_path, "port")
    ref = _cache_walk(rcache, rsynth, tmp_path, "ref")
    assert mine == ref
    assert mine[0] == (True, True, True)
    assert mine[1] == {"entries": 16, "hits": 2, "misses": 20,
                       "capacity": 16}
    assert pcache.trace_cache_stats()["entries"] == 0


# ---------------------------------------------------------------- package


def test_lazy_package_surface():
    assert ptrace.__all__ == rtrace.__all__
    assert ptrace._LAZY == rtrace._LAZY
    assert ptrace._LAZY_SYMBOLS == rtrace._LAZY_SYMBOLS
    for name in ptrace._LAZY:
        assert getattr(ptrace, name) is \
            sys.modules[f"repro_torch.trace.{name}"]
    for name, mod in ptrace._LAZY_SYMBOLS.items():
        assert getattr(ptrace, name) is \
            getattr(sys.modules[f"repro_torch.trace.{mod}"], name)
    with pytest.raises(AttributeError):
        ptrace.not_a_symbol      # noqa: B018
