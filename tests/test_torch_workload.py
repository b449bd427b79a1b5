"""Port workloads and metrics against the reference: every synthetic
generator's arrays are bit-equal for the same seed, and the metrics give
the same rows on the same arrays."""
import dataclasses

import numpy as np
import pytest

import repro.core as rc
from repro.core import metrics as rmetrics

from repro_torch import convert
from repro_torch.core import metrics, workload
from repro_torch.core import PAPER_SMALL, PAPER_TESTBED

FIELDS = ("arrival", "func", "service", "u_lb", "func_home")


def _same(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("name", sorted(workload.WORKLOADS))
def test_generators_bit_equal(name, seed):
    for cluster in (PAPER_SMALL, PAPER_TESTBED):
        mine = workload.WORKLOADS[name](cluster, 0.7, 500, seed)
        ref = rc.WORKLOADS[name](rc.ClusterCfg(*cluster[:4]), 0.7, 500,
                                 seed)
        for f in FIELDS:
            _same(getattr(mine, f), getattr(ref, f))
        assert (mine.n_functions, mine.load, mine.name) == \
            (ref.n_functions, ref.load, ref.name)


def test_replicate_and_convert_round_trip():
    loads, seeds = (0.3, 0.9), (0, 2)
    mine = workload.replicate_workload(workload.ms_trace, PAPER_SMALL,
                                       loads, 200, seeds=seeds)
    ref = rc.replicate_workload(rc.ms_trace, rc.PAPER_SMALL, loads, 200,
                                seeds=seeds)
    for f in FIELDS:
        _same(getattr(mine, f), getattr(ref, f))
    again = convert.batch_from_arrays(
        *(getattr(ref, f) for f in FIELDS), ref.n_functions, ref.loads,
        ref.names)
    for f in FIELDS:
        _same(getattr(again, f), getattr(ref, f))
    one = convert.workload_from_arrays(
        *(getattr(ref.rep(1), f) for f in FIELDS), ref.n_functions,
        ref.loads[1], ref.names[1])
    _same(one.arrival, ref.arrival[1])
    assert convert.cluster_from_fields(*rc.PAPER_TESTBED[:4]) == \
        PAPER_TESTBED


def test_validation_errors():
    wl = workload.ms_trace(PAPER_SMALL, 0.5, 50, 0)
    with pytest.raises(ValueError, match="func ids"):
        convert.workload_from_arrays(
            wl.arrival, wl.func + 100, wl.service, wl.u_lb, wl.func_home,
            wl.n_functions, wl.load)
    with pytest.raises(ValueError, match="non-decreasing"):
        workload.validate_workload(dataclasses.replace(
            wl, arrival=wl.arrival[::-1].copy()))
    with pytest.raises(ValueError, match=r"share \(N, F\)"):
        workload.stack_workloads(
            [wl, workload.ms_trace(PAPER_SMALL, 0.5, 60, 0)])


def _fake_results(rng, R, N):
    response = rng.exponential(3.0, (R, N))
    response[rng.uniform(size=(R, N)) < 0.05] = np.nan
    service = rng.exponential(1.0, (R, N))
    cold = rng.uniform(size=(R, N)) < 0.2
    rejected = np.isnan(response) & (rng.uniform(size=(R, N)) < 0.5)
    server = rng.uniform(10, 20, R)
    core = rng.uniform(20, 40, R)
    end = rng.uniform(50, 60, R)
    return response, service, cold, rejected, server, core, end


def _rows_equal(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in a:
        assert (a[k] == b[k]) or (np.isnan(a[k]) and np.isnan(b[k])), k


@pytest.mark.parametrize("seed", range(3))
def test_summaries_match(seed):
    rng = np.random.default_rng(seed)
    resp, svc, cold, rej, server, core, end = _fake_results(rng, 3, 400)
    for r in range(3):
        args = (resp[r], svc[r], cold[r], rej[r], float(server[r]),
                float(core[r]), float(end[r]))
        _rows_equal(metrics.summarize(*args).row(),
                    rmetrics.summarize(*args).row())
    mine = metrics.summarize_batch(resp, svc, cold, rej, server, core, end)
    ref = rmetrics.summarize_batch(resp, svc, cold, rej, server, core, end)
    _rows_equal(mine.row(), ref.row())
    for a, b in zip(mine.per_rep, ref.per_rep):
        _rows_equal(a.row(), b.row())


def test_summarize_sim_wrappers_match():
    rng = np.random.default_rng(9)
    resp, svc, cold, rej, server, core, end = _fake_results(rng, 2, 300)
    from repro_torch.core.simulator import BatchSimOutput
    out = BatchSimOutput(response=resp, cold=cold, rejected=rej,
                         worker=np.zeros(resp.shape, np.int32),
                         server_time=server, core_time=core, end_time=end)
    wb = workload.ms_trace(PAPER_SMALL, 0.5, 300, 0)
    wb = workload.stack_workloads([dataclasses.replace(wb, service=svc[0]),
                                   dataclasses.replace(wb, service=svc[1])])
    _rows_equal(metrics.summarize_batch_sim(out, wb).row(),
                rmetrics.summarize_batch_sim(out, wb).row())
    _rows_equal(metrics.summarize_sim(out.rep(1), wb.rep(1)).row(),
                rmetrics.summarize_sim(out.rep(1), wb.rep(1)).row())
