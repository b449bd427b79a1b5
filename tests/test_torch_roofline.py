"""The roofline re-targeted to the H100 (``repro_torch.roofline``).

* ``model_flops``, ``_cache_bytes`` and ``min_bytes`` equal to the
  reference's, bit for bit, for every arch × shape × mesh (pure
  arithmetic on the configs, here in the test process);
* the hardware model is the H100's data sheet (no TPU figure), and a
  cell's three terms are its census counts over those rates;
* the hillclimb's granite-20b and deepseek-v2-236b ``decode_32k`` rungs
  move the terms the way their hypotheses say: the flash-decode merge
  cuts granite's collective and memory terms, the latent flash-decode
  cuts deepseek's memory term, the serving weight layout its collective
  term.  They trace on a fake world, in one subprocess of this file.
"""
import json
import os
import subprocess
import sys

import pytest

from repro import configs as jconfigs
from repro.configs.shapes import SHAPES as JSHAPES
from repro.roofline import analysis as janalysis
from repro.roofline import report as jreport
from repro_torch import configs
from repro_torch.configs.shapes import SHAPES
from repro_torch.roofline import analysis, report

SRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src")

SCRIPT = """
import json
from repro_torch.roofline import hillclimb
from repro_torch.launch.dryrun import run_cell
from repro_torch.roofline.analysis import roofline_of
rows = hillclimb.run(hillclimb.RUNS[:5], out=None)
cell = run_cell("olmo-1b", "decode_32k", multi_pod=True)
print(json.dumps(dict(rows=rows, cell=cell.row(),
                      roofline=roofline_of(cell).row())))
"""


@pytest.mark.parametrize("arch", configs.ARCH_NAMES)
def test_arithmetic_equals_reference(arch):
    cfg, jcfg = configs.get(arch), jconfigs.get(arch)
    for name in SHAPES:
        shape, jshape = SHAPES[name], JSHAPES[name]
        assert analysis.model_flops(cfg, shape) == \
            janalysis.model_flops(jcfg, jshape)
        assert report._cache_bytes(cfg, shape) == \
            jreport._cache_bytes(jcfg, jshape)
        for chips in (256, 512):
            assert report.min_bytes(cfg, shape, chips) == \
                jreport.min_bytes(jcfg, jshape, chips)
    assert analysis._unit(cfg) == janalysis._unit(jcfg)


def test_hardware_is_the_h100s():
    assert analysis.PEAK_FLOPS == 989e12 == analysis.H100_BF16_PEAK_FLOPS
    assert analysis.HBM_BW == 3.35e12
    assert analysis.H100_NVLINK_BW == 450e9
    assert analysis.IB_NDR_BW == 50e9
    assert analysis.H100_HBM_BYTES == 80e9
    # the TPU v5e's peak and HBM rate and its cross-pod link (its in-pod
    # link's 50 GB/s is also one InfiniBand NDR port's)
    for tpu in (janalysis.PEAK_FLOPS, janalysis.HBM_BW, janalysis.DCI_BW):
        assert tpu not in vars(analysis).values()


@pytest.fixture(scope="module")
def climbed():
    proc = subprocess.run([sys.executable, "-c", SCRIPT],
                          env=dict(os.environ, PYTHONPATH=SRC),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_terms_are_counts_over_rates(climbed):
    c, r = climbed["cell"], climbed["roofline"]
    coll = c["collectives"]
    assert r["t_compute"] == c["flops"] / 989e12
    assert r["t_memory"] == c["bytes_accessed"] / 3.35e12
    assert r["t_collective"] == pytest.approx(
        (coll["total"] - coll["cross_node"]) / 450e9
        + coll["cross_node"] / 50e9, rel=1e-12)
    assert r["peak_memory_bytes"] == c["peak_memory_bytes"]
    e = report.enrich(r)
    assert e["fits"] == (c["peak_memory_bytes"] <= 80e9)
    assert "| olmo-1b | decode_32k | 2x16x16 |" in report.to_markdown([e])


def _rung(rows, arch, label):
    return next(r for r in rows if r["arch"] == arch and r["label"] == label)


def test_granite_flash_decode_cuts_collective_and_memory(climbed):
    base = _rung(climbed["rows"], "granite-20b", "baseline")
    flash = _rung(climbed["rows"], "granite-20b", "+flash-decode")
    assert flash["t_collective"] < base["t_collective"]
    assert flash["t_memory"] < base["t_memory"]


def test_deepseek_rungs_cut_memory_then_collective(climbed):
    rows = climbed["rows"]
    base = _rung(rows, "deepseek-v2-236b", "baseline")
    mla = _rung(rows, "deepseek-v2-236b", "+mla-flash-decode")
    serve = _rung(rows, "deepseek-v2-236b", "+serving-weight-layout")
    assert mla["t_memory"] < base["t_memory"]
    assert serve["t_collective"] < mla["t_collective"]
