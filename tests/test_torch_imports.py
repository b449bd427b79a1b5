"""The port stands alone: no JAX, no ``repro``, and no silent CPU run.

* no file of ``src/repro_torch`` and not ``chip_smoke.py`` imports
  ``jax`` or ``repro`` (AST walk);
* importing the engine and the trace package (its lazy submodules too)
  in a fresh process leaves both out of ``sys.modules``;
* without a CUDA card, the entry points' default device raises the
  named error, and ``chip_smoke.py`` exits non-zero without a result.
"""
import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + \
    [REPO / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_reference_imports(path):
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.name} imports {bad}"


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO / "src")
    return env


def test_engine_import_leaves_jax_and_reference_out():
    # the trace package's submodules load lazily (PEP 562), which the AST
    # walk cannot follow: reach each through the package's __getattr__
    code = ("import sys, repro_torch.core.simulator, repro_torch.convert, "
            "repro_torch.kernels._build, "
            "repro_torch.kernels.sim_engine.ops, repro_torch.trace, "
            "repro_torch.core.sim_ref, repro_torch.core.policies, "
            "repro_torch.distribution.sharding, repro_torch.launch.mesh, "
            "repro_torch.launch.specs, repro_torch.launch.train, "
            "repro_torch.training.train, repro_torch.launch.dryrun, "
            "repro_torch.roofline.analysis, repro_torch.roofline.report, "
            "repro_torch.roofline.hillclimb\n"
            "for name in ('schema', 'synth_trace', 'replay', 'cache'):\n"
            "    mod = getattr(repro_torch.trace, name)\n"
            "    assert mod.__name__ == 'repro_torch.trace.' + name, mod\n"
            "repro_torch.trace.resample_workloads\n"
            "repro_torch.core.WORKLOADS['azure-fixture']("
            "repro_torch.core.PAPER_SMALL, 0.5, 50, 0)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]\n"
            "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], env=_env(),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    from repro_torch.core import PAPER_SMALL, HERMES, WORKLOADS, ms_trace
    from repro_torch.core.simulator import simulate
    from repro_torch.device import NoCudaDeviceError
    from repro_torch.kernels.hermes_select.ops import hermes_select
    from repro_torch.policy import resolve
    wl = ms_trace(PAPER_SMALL, 0.5, 20, 0)
    with pytest.raises(NoCudaDeviceError):
        simulate(HERMES, PAPER_SMALL, wl)
    azure = WORKLOADS["azure-diurnal"](PAPER_SMALL, 0.5, 20, 0)
    with pytest.raises(NoCudaDeviceError):
        simulate(HERMES, PAPER_SMALL, azure)
    with pytest.raises(NoCudaDeviceError):
        resolve(HERMES, PAPER_SMALL)
    with pytest.raises(NoCudaDeviceError):
        hermes_select([0, 1], [[1], [0]], [0], cores=1, slots=2)


def _run_smoke(cwd: Path):
    return subprocess.run([sys.executable, str(cwd / "chip_smoke.py")],
                          cwd=cwd, env=_env(), capture_output=True,
                          text=True, timeout=120)


def _printed_ok(stdout: str) -> bool:
    for line in stdout.splitlines():
        try:
            if json.loads(line).get("ok"):
                return True
        except (ValueError, AttributeError):
            continue
    return False


def test_chip_smoke_fails_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    proc = _run_smoke(REPO)
    assert proc.returncode != 0 and not _printed_ok(proc.stdout)


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = _run_smoke(tmp_path)
    assert proc.returncode != 0 and not _printed_ok(proc.stdout)
