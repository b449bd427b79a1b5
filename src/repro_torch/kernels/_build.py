"""Build the port's CUDA sources with ``nvcc`` at first use.

Each ``src/repro_torch/csrc/<name>.cu`` becomes a shared library with a
plain C interface, ``build/kernels/<name>-<hash>.so`` under the checkout,
loaded with :mod:`ctypes`.  A source with many template instantiations
is built in parts (:data:`PARTS`): part ``i`` is the library
``<name>@<i>``, the same source compiled with that part's defines, which
hold a share of the instantiations; the caller loads the part that holds
the kernel it launches.  The hash covers the sources and the flags, so
an edited source rebuilds and an unchanged one is reused.  Everything is
built from the sources in the repository; nothing is fetched.
:func:`build_all` starts one ``nvcc`` per library, all at once, and waits
for them together.  A failed build raises :class:`KernelBuildError` with
``nvcc``'s output.  ``nvcc``'s resource report (``-Xptxas -v``) is kept
beside each library as ``<name>-<hash>.log``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: the defines of each part of a source built in parts: ``sim_engine``'s
#: 54 instantiations as six libraries, part ``3 * life + mode`` for each
#: lifecycle switch and observation mode, nine balancers each
PARTS = {"sim_engine": tuple(
    (f"-DSIM_ENGINE_LIFE={life}", f"-DSIM_ENGINE_OBS={mode}")
    for life in (0, 1) for mode in (0, 1, 2))}

_LOADED: dict[str, ctypes.CDLL] = {}


class KernelBuildError(RuntimeError):
    """``nvcc`` is missing or refused a source."""


def sources() -> list[str]:
    """Names of the kernel sources (``csrc/<name>.cu``)."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def libraries() -> list[str]:
    """Names of the libraries the sources build: ``<name>``, or
    ``<name>@<i>`` for each part of a source built in parts."""
    return [lib for n in sources() for lib in (
        [f"{n}@{i}" for i in range(len(PARTS[n]))] if n in PARTS else [n])]


def _source_and_defines(lib: str) -> tuple[str, tuple[str, ...]]:
    name, _, part = lib.partition("@")
    return name, PARTS[name][int(part)] if part else ()


def _nvcc() -> str:
    """``nvcc`` on PATH, else under ``$CUDA_HOME`` or the toolkit's
    default prefix."""
    found = shutil.which("nvcc")
    if found is not None:
        return found
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").exists():
            return str(Path(home) / "bin" / "nvcc")
    raise KernelBuildError(
        "nvcc not found on PATH, under $CUDA_HOME or /usr/local/cuda; the "
        "CUDA kernels are built on a machine with the CUDA toolkit")


def library_path(lib: str) -> Path:
    name, defines = _source_and_defines(lib)
    digest = hashlib.sha256()
    for p in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        digest.update(p.read_bytes())
    digest.update(" ".join(NVCC_FLAGS + defines).encode())
    return BUILD_DIR / f"{lib}-{digest.hexdigest()[:16]}.so"


def build_all(names=None) -> dict[str, float]:
    """Compile the named libraries (default: all) that are not built yet.

    Returns the seconds each compile took (0.0 for one already built).
    """
    names = libraries() if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    seconds = {n: 0.0 for n in names}
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return seconds
    nvcc = _nvcc()
    procs = {}
    for n in todo:
        name, defines = _source_and_defines(n)
        tmp = library_path(n).with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, *defines, "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp, time.perf_counter())
    failed = []
    for n, (proc, tmp, t0) in procs.items():
        out, _ = proc.communicate()
        seconds[n] = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"--- {n} (nvcc exit {proc.returncode}) ---\n"
                          f"{out}")
            continue
        library_path(n).with_suffix(".log").write_text(out)
        os.replace(tmp, library_path(n))
    if failed:
        raise KernelBuildError("nvcc failed:\n" + "\n".join(failed))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The built library ``name`` (``csrc/<name>.cu``, or a part
    ``<name>@<i>``), building it if needed."""
    lib = _LOADED.get(name)
    if lib is None:
        build_all([name])
        lib = _LOADED[name] = ctypes.CDLL(str(library_path(name)))
    return lib
