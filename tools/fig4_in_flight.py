#!/usr/bin/env python3
"""How far into fig4's inputs the cluster reaches its steady load.

    PYTHONPATH=src python tools/fig4_in_flight.py [-n 6000] [--policies H,LL,LOC,R]

Runs fig4's inputs (``PAPER_LARGE``, ``ms-trace`` at loads 0.5, 0.7, 0.9
and 0.97, seed 1: ``chip_smoke.py`` phases 4 and 5) through the port's
engine on the CPU and prints, for each early-binding PS policy and load,
the tasks in flight at each arrival: their steady mean over the second
half of the run, the arrival at which they first reach 90 % of it, and
at prefixes of 500-3000 arrivals the peak and the share of arrivals that
land on a worker already holding a task a core (those share cores under
PS).  ``chip_smoke.py``'s ``N_CHECK`` is chosen from these lines.
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

LOADS = (0.5, 0.7, 0.9, 0.97)
PREFIXES = (500, 1000, 2000, 3000)


def in_flight(arrival, response, rejected):
    """Tasks admitted before each arrival and not yet finished at it: a
    task ends after it arrives, so the ``i``-th arrival sees ``i`` earlier
    tasks less those that ended by its time."""
    end = np.where(rejected, -np.inf, arrival + np.nan_to_num(response))
    ended = np.searchsorted(np.sort(end), arrival, side="right")
    return np.arange(arrival.size) - ended


def on_busy_worker(arrival, response, rejected, worker, cores):
    """Whether each arrival lands on a worker already holding ``cores``
    unfinished tasks."""
    out = np.zeros(arrival.size, bool)
    end = np.where(rejected, -np.inf, arrival + np.nan_to_num(response))
    for w in np.unique(worker):
        idx = np.flatnonzero(worker == w)
        ends = np.sort(end[idx])
        held = np.arange(idx.size) - np.searchsorted(ends, arrival[idx],
                                                     side="right")
        out[idx] = held >= cores
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("-n", type=int, default=6000)
    ap.add_argument("--policies", default="H,LL,LOC,R")
    args = ap.parse_args(argv)
    from repro_torch.core import (E_LL_PS, E_LOC_PS, E_R_PS, HERMES,
                                  PAPER_LARGE, ms_trace, replicate_workload)
    from repro_torch.core.simulator import simulate_many
    policies = {"H": HERMES, "LL": E_LL_PS, "LOC": E_LOC_PS, "R": E_R_PS}
    wb = replicate_workload(ms_trace, PAPER_LARGE, LOADS, args.n, seeds=(1,))
    for name in args.policies.split(","):
        t0 = time.perf_counter()
        out = simulate_many(policies[name], PAPER_LARGE, wb, device="cpu")
        print(f"E/{name}/PS, N={args.n}: {time.perf_counter() - t0:.1f} s "
              f"on the CPU")
        for r, load in enumerate(LOADS):
            args_r = (wb.arrival[r], out.response[r], out.rejected[r])
            fl = in_flight(*args_r)
            busy = on_busy_worker(*args_r, out.worker[r], PAPER_LARGE.cores)
            steady = fl[args.n // 2:].mean()
            reach = int(np.argmax(fl >= 0.9 * steady))
            pre = "; ".join(
                f"first {n}: peak {fl[:n].max()} "
                f"({fl[:n].max() / steady:.0%}), onto a full worker "
                f"{busy[:n].mean():.0%}" for n in PREFIXES if n <= args.n)
            print(f"  load {load}: steady {steady:.0f} in flight, 90 % of it "
                  f"at arrival {reach}; {pre}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
