"""The windowed flight recorder's host side and torch twins on the CPU.

* ``repro_torch.telemetry.timeline`` against ``repro.telemetry.timeline``:
  the named validation errors, ``window_index_np`` (its clip and the
  degenerate width), the widths and coarse edges, each numpy updater and
  ``sensor_p99_np`` on the same random events, bit for bit;
  ``TimelineResult``'s ``to_rows``, ``summary``, ``events``,
  ``replay_n_on`` (and its refusal of a truncated log), the CSV and
  OpenMetrics text and the counter tracks, equal to the reference's on
  the same state.
* The torch twins (``timeline_engine``) over ``[R, …]`` state against the
  numpy updaters row by row, on random events with per-replication masks,
  at window edges, past the horizon and for a width of 0; the spare rows
  take what the masks turn off and never reach the result.

Inputs come from ``numpy.random.default_rng`` seeds.  Where JAX is not
installed, the reference-side tests skip.
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.telemetry import Tracer, spans
from repro_torch.telemetry import timeline as tln
from repro_torch.telemetry import timeline_engine as tle
from repro_torch.telemetry.engine import edges_for
from repro_torch.telemetry.sketch import N_BINS, bin_midpoints, hist_edges

try:
    from repro.telemetry import spans as ref_spans
    from repro.telemetry import timeline as ref_tln
except ImportError:     # no JAX installed: the reference tests skip
    ref_tln = None

CFG = tln.TimelineCfg(n_windows=8, window_s=0.0, coarse_bins=48,
                      max_events=6)
W = 3
HORIZON = 40.0
NPF = ("arrivals", "n_cold", "n_warm", "n_evict", "n_reject", "slow_hist",
       "lat_hist", "busy_time", "qlen_time", "prov_core", "n_on", "ev_t",
       "ev_kind", "ev_val", "ev_p99", "ev_count", "mode", "window_s")


@pytest.fixture
def reference():
    if ref_tln is None:
        pytest.skip("the JAX reference package is not installed here")


def _events(seed, n=120):
    """A random sequence of timeline events: (kind, time, operands)."""
    rng = np.random.default_rng(seed)
    ws = HORIZON / CFG.n_windows
    out = []
    for _ in range(n):
        kind = rng.integers(0, 9)
        # times on window edges, inside, past the horizon and negative
        t = float(rng.choice([rng.uniform(-2.0, HORIZON + 10.0),
                              ws * rng.integers(0, CFG.n_windows + 2)]))
        if kind == 0:
            out.append(("arrival", t, int(rng.integers(1, W + 1))))
        elif kind == 1:
            out.append(("place", t, bool(rng.random() < 0.4),
                        bool(rng.random() < 0.2)))
        elif kind == 2:
            out.append(("advance", t, float(rng.exponential(0.7)),
                        rng.random(W) < 0.6, int(rng.integers(0, 4))))
        elif kind == 3:
            resp = float(rng.lognormal(0.0, 2.0))
            out.append(("complete", t, resp,
                        float(resp / rng.uniform(1.0, 30.0))))
        elif kind == 4:
            out.append(("evict", t))
        elif kind == 5:
            out.append(("reject", t))
        elif kind == 6:
            out.append(("prov", t, float(rng.exponential(5.0))))
        elif kind == 7:
            window = np.zeros(N_BINS, dtype=np.int64)
            idx = rng.integers(0, N_BINS, size=int(rng.integers(1, 40)))
            np.add.at(window, idx, 1)
            out.append(("autoscale", t, int(rng.integers(1, W + 1)), window))
        else:
            out.append(("flip", t, int(rng.integers(0, 2))))
    return out


def _apply_np(mod, tl, ev):
    """One event through a timeline module's numpy updaters."""
    kind, t = ev[0], ev[1]
    if kind == "arrival":
        mod.tl_on_arrival_np(tl, t, ev[2])
    elif kind == "place":
        mod.tl_on_place_np(tl, t, ev[2], ev[3])
    elif kind == "advance":
        mod.tl_on_advance_np(tl, t, ev[2], ev[3], ev[4])
    elif kind == "complete":
        mod.tl_on_complete_np(tl, t, ev[2], ev[3])
    elif kind == "evict":
        mod.tl_on_evict_np(tl, t)
    elif kind == "reject":
        mod.tl_on_reject_np(tl, t)
    elif kind == "prov":
        mod.tl_on_prov_np(tl, t, ev[2])
    elif kind == "autoscale":
        mod.tl_event_np(tl, t, mod.EV_AUTOSCALE, ev[2],
                        mod.sensor_p99_np(ev[3]))
    else:
        mod.tl_event_np(tl, t, mod.EV_MODE_FLIP, ev[2], float("nan"))
        tl["mode"] = np.int32(ev[2])


def _run_np(mod, seed, window_s=HORIZON / CFG.n_windows):
    cfg = mod.TimelineCfg(*CFG)
    tl = mod.init_tl_np(W, cfg, window_s)
    for ev in _events(seed):
        _apply_np(mod, tl, ev)
    return tl


def _same_state(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype and x.shape == y.shape, k
        assert x.tobytes() == y.tobytes(), k


@pytest.mark.parametrize("bad, words", [
    (dict(n_windows=0), "n_windows must be >= 1"),
    (dict(max_events=0), "max_events must be >= 1"),
    (dict(coarse_bins=0), "coarse_bins must be a positive divisor"),
    (dict(coarse_bins=7), "coarse_bins must be a positive divisor"),
    (dict(coarse_bins=3072), "coarse_bins must be a positive divisor"),
])
def test_validation_errors(reference, bad, words):
    with pytest.raises(ValueError, match=words) as ours:
        tln.validate_timeline(tln.TimelineCfg()._replace(**bad))
    with pytest.raises(ValueError) as theirs:
        ref_tln.validate_timeline(ref_tln.TimelineCfg()._replace(**bad))
    assert str(ours.value) == str(theirs.value)


@pytest.mark.parametrize("now, w, k", [
    (0.0, 1.0, 4), (3.999999, 1.0, 4), (4.0, 1.0, 4), (1e9, 1.0, 4),
    (-0.5, 1.0, 4), (7.0, 0.0, 4), (7.0, -1.0, 4), (0.3, 0.1, 10),
    (2.9999999999999996, 0.1, 64), (5.0, 5.0, 1), (1e17, 1e-3, 64),
])
def test_window_index(reference, now, w, k):
    want = ref_tln.window_index_np(now, w, k)
    assert tln.window_index_np(now, w, k) == want
    got = tle.window_index(torch.tensor([now], dtype=torch.float64),
                           torch.tensor([w], dtype=torch.float64), k)
    assert got.dtype == torch.int64 and int(got[0]) == want


@pytest.mark.parametrize("cfg", [tln.TimelineCfg(),
                                 tln.TimelineCfg(32, 0.0, 96, 128),
                                 tln.TimelineCfg(5, 2.5, 1536, 1)])
def test_widths_and_coarse_edges(reference, cfg):
    rcfg = ref_tln.TimelineCfg(*cfg)
    for horizon in (0.0, 1234.5678, 86399.99):
        assert tln.auto_window_s(horizon, cfg) == \
            ref_tln.auto_window_s(horizon, rcfg)
    assert tln.coarse_group(cfg) == ref_tln.coarse_group(rcfg)
    assert tln.coarse_edges(cfg).tobytes() == \
        ref_tln.coarse_edges(rcfg).tobytes()
    arrival = torch.tensor([[0.0, 1234.5678], [3.0, 86399.99]],
                           dtype=torch.float64)
    got = tle.widths(arrival, cfg)
    assert got.tolist() == [ref_tln.auto_window_s(h, rcfg)
                            for h in (1234.5678, 86399.99)]


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_numpy_updaters_equal_the_reference(reference, seed):
    _same_state(_run_np(tln, seed), _run_np(ref_tln, seed))


def test_numpy_updaters_at_a_width_of_zero(reference):
    # a degenerate horizon: every event lands in window 0
    ours, theirs = _run_np(tln, 7, 0.0), _run_np(ref_tln, 7, 0.0)
    _same_state(ours, theirs)
    assert ours["arrivals"][1:].sum() == 0


def test_sensor_p99_equals_the_reference(reference):
    rng = np.random.default_rng(11)
    windows = [np.eye(N_BINS, dtype=np.int64)[0],
               np.eye(N_BINS, dtype=np.int64)[N_BINS - 1],
               np.full(N_BINS, 3, dtype=np.int64)]
    for _ in range(40):
        w = np.zeros(N_BINS, dtype=np.int64)
        np.add.at(w, rng.integers(0, N_BINS, size=rng.integers(1, 500)), 1)
        windows.append(w)
    mids = tle.midpoints_for("cpu")
    stacked = torch.as_tensor(np.stack(windows))
    twin = tle.sensor_p99(stacked, mids).numpy()
    for w, t in zip(windows, twin):
        want = ref_tln.sensor_p99_np(w)
        assert tln.sensor_p99_np(w) == want
        assert t == want


def test_bin_midpoints_are_correctly_rounded():
    e = hist_edges()
    want = [math.sqrt(float(e[b]) * float(e[b + 1])) for b in range(N_BINS)]
    assert bin_midpoints().tolist() == want


def _run_torch(seed, R=3):
    """The same kind of random events through the torch twins over R rows
    (each event on a random subset of rows), and through the numpy
    updaters for each row it reaches."""
    rng = np.random.default_rng(100 + seed)
    widths = np.array([HORIZON / CFG.n_windows, 0.0, 2.5])[:R]
    st = tle.init_state(R, W, CFG, torch.as_tensor(widths), "cpu")
    nps = [tln.init_tl_np(W, CFG, float(widths[r])) for r in range(R)]
    edges, mids = edges_for("cpu"), tle.midpoints_for("cpu")
    f64 = torch.float64
    for ev in _events(seed):
        mask = rng.random(R) < 0.7
        m = torch.as_tensor(mask)
        t = torch.full((R,), ev[1], dtype=f64)
        kind = ev[0]
        if kind == "arrival":
            st = tle.on_arrival(st, t, ev[2], m)
        elif kind == "place":
            st = tle.on_place(st, t, torch.full((R,), ev[2]),
                              torch.full((R,), ev[3]), m)
        elif kind == "advance":
            st = tle.on_advance(st, t, torch.full((R,), ev[2], dtype=f64),
                                torch.as_tensor(ev[3]).expand(R, W),
                                torch.full((R,), ev[4]), m)
        elif kind == "complete":
            st = tle.on_complete(st, t, torch.full((R,), ev[2], dtype=f64),
                                 torch.full((R,), ev[3], dtype=f64), m,
                                 edges)
        elif kind == "evict":
            st = tle.on_evict(st, t, torch.ones(R, dtype=torch.int64), m)
        elif kind == "reject":
            st = tle.on_reject(st, t, torch.ones(R, dtype=torch.bool), m)
        elif kind == "prov":
            st = tle.on_prov(st, t, torch.full((R,), ev[2], dtype=f64), m)
        elif kind == "autoscale":
            p99 = tle.sensor_p99(torch.as_tensor(ev[3])[None].expand(R, -1),
                                 mids)
            st = tle.on_event(st, m, t, tln.EV_AUTOSCALE, ev[2], p99)
        else:
            mode = torch.full((R,), ev[2], dtype=torch.int32)
            st = tle.on_event(st, m & (mode != st["mode"]), t,
                              tln.EV_MODE_FLIP, mode, torch.nan)
            st["mode"] = torch.where(m, mode, st["mode"])
        for r in np.nonzero(mask)[0]:
            if kind == "flip":
                if ev[2] != int(nps[r]["mode"]):
                    _apply_np(tln, nps[r], ev)
                nps[r]["mode"] = np.int32(ev[2])
            else:
                _apply_np(tln, nps[r], ev)
    return st, nps


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4])
def test_torch_twins_equal_the_numpy_updaters(seed):
    st, nps = _run_torch(seed)
    res = tle.result_of(st, CFG)
    for r, want in enumerate(nps):
        got = res.rep(r)
        for k in NPF:
            x, y = np.asarray(getattr(got, k)), np.asarray(want[k])
            assert x.dtype == y.dtype and x.shape == y.shape, k
            assert x.tobytes() == y.tobytes(), (r, k)


def test_spare_rows_take_the_masked_events():
    st, _ = _run_torch(0)
    # the masked-off events landed in the spare window and log entry, and
    # result_of slices them away
    assert int(st["arrivals"][:, -1].sum()) > 0
    assert int(st["ev_count"].max()) > CFG.max_events
    res = tle.result_of(st, CFG)
    assert res.arrivals.shape == (3, CFG.n_windows)
    assert res.ev_t.shape == (3, CFG.max_events)
    assert res.slow_hist.shape == (3, CFG.n_windows, CFG.coarse_bins)


def _results(seed, batched=False):
    states = [_run_np(tln, seed + r) for r in range(2 if batched else 1)]
    rstates = [_run_np(ref_tln, seed + r) for r in range(2 if batched else 1)]

    def stack(sts, mod):
        if not batched:
            return mod.TimelineResult.from_state(
                sts[0], cfg=mod.TimelineCfg(*CFG))
        return mod.TimelineResult.from_state(
            {k: np.stack([np.asarray(s[k]) for s in sts]) for k in sts[0]},
            cfg=mod.TimelineCfg(*CFG))
    return stack(states, tln), stack(rstates, ref_tln)


@pytest.mark.parametrize("seed", [0, 5])
@pytest.mark.parametrize("batched", [False, True])
def test_result_readers_equal_the_reference(reference, tmp_path, seed,
                                            batched):
    ours, theirs = _results(seed, batched)
    assert repr(ours.to_rows()) == repr(theirs.to_rows())
    assert repr(ours.summary()) == repr(theirs.summary())
    assert ours.to_openmetrics() == theirs.to_openmetrics()
    assert ours.window_starts().tobytes() == theirs.window_starts().tobytes()
    a = ours.write_csv(str(tmp_path / "ours" / "tl.csv"))
    b = theirs.write_csv(str(tmp_path / "theirs" / "tl.csv"))
    assert open(a).read() == open(b).read()
    a = ours.write_openmetrics(str(tmp_path / "ours" / "tl.om"))
    b = theirs.write_openmetrics(str(tmp_path / "theirs" / "tl.om"))
    assert open(a).read() == open(b).read()
    if batched:
        with pytest.raises(ValueError, match="per-replication"):
            ours.events()
        with pytest.raises(ValueError, match="single replication"):
            ours.replay_n_on(W)
        for r in range(2):
            assert repr(ours.rep(r).summary()) == \
                repr(theirs.rep(r).summary())
            assert repr(ours[r].events()) == repr(theirs[r].events())
    else:
        assert repr(ours.events()) == repr(theirs.events())


def test_replay_and_truncation(reference):
    # a log within its bound replays; a truncated one is refused by name
    cfg = tln.TimelineCfg(8, 0.0, 48, 64)
    rcfg = ref_tln.TimelineCfg(*cfg)
    tl, rtl = tln.init_tl_np(W, cfg, 5.0), ref_tln.init_tl_np(W, rcfg, 5.0)
    rng = np.random.default_rng(3)
    level = W
    for t in np.sort(rng.uniform(0, 40, 60)):
        if rng.random() < 0.2:
            level = int(rng.integers(1, W + 1))
            for mod, s in ((tln, tl), (ref_tln, rtl)):
                mod.tl_event_np(s, float(t), mod.EV_AUTOSCALE, level, 1.5)
        for mod, s in ((tln, tl), (ref_tln, rtl)):
            mod.tl_on_arrival_np(s, float(t), level)
    ours = tln.TimelineResult.from_state(tl, cfg=cfg)
    theirs = ref_tln.TimelineResult.from_state(rtl, cfg=rcfg)
    rep = ours.replay_n_on(W)
    assert rep.tobytes() == theirs.replay_n_on(W).tobytes()
    has = ours.arrivals > 0
    assert np.array_equal(rep[has], ours.n_on[has])
    ours_t, theirs_t = _results(1)
    assert int(ours_t.ev_count) > CFG.max_events
    with pytest.raises(ValueError, match="decision log truncated") as a:
        ours_t.replay_n_on(W)
    with pytest.raises(ValueError) as b:
        theirs_t.replay_n_on(W)
    assert str(a.value) == str(b.value)
    assert ours_t.summary()["n_events_dropped"] == \
        theirs_t.summary()["n_events_dropped"] > 0


def test_counter_tracks_equal_the_reference(reference):
    ours, theirs = _results(2)
    a, b = Tracer(enabled=True), ref_spans.Tracer(enabled=True)
    ours.emit_counters(a)
    theirs.emit_counters(b)
    assert a.events == b.events
    assert all(e["ph"] == "C" and e["pid"] == spans.VIRTUAL_PID
               for e in a.events)


def test_from_state_takes_torch_tensors():
    tl = _run_np(tln, 4)
    res = tln.TimelineResult.from_state(
        {k: torch.as_tensor(np.asarray(v)) for k, v in tl.items()}, cfg=CFG)
    want = tln.TimelineResult.from_state(tl, cfg=CFG)
    for k in NPF:
        assert np.asarray(getattr(res, k)).tobytes() == \
            np.asarray(getattr(want, k)).tobytes(), k
