"""Step-atomic checkpointing (counterpart of
``repro/training/checkpoint.py``, the reference's on-disk layout).

Format: one directory per step containing ``arrays.npz`` (the flattened
leaves as ``a0 … aN``) and ``manifest.json`` (``{"step", "keys"}``, each
key the leaf's path joined by ``/``); written to ``<step>.tmp`` and
committed with an atomic ``os.replace`` so a crash mid-save never
corrupts the latest checkpoint.  bfloat16 leaves, which numpy has no type
for, are stored by their bits (``uint16``) and restored into ``like``'s
dtype.  There is no sharding yet, so a restore places every leaf on the
device and dtype of the matching leaf of ``like``.

The copy to the host runs on the calling thread (so the saved state is
the state at ``save``); the npz write runs on a background thread and
``wait()`` joins it.
"""
from __future__ import annotations

import json
import os
import shutil
import threading

import numpy as np
import torch

from repro_torch.training.tree import flatten_with_paths, unflatten_like


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:                  # carry the bits
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _from_numpy(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    if like.dtype == torch.bfloat16 and a.dtype == np.uint16:
        t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a, copy=True)).to(like.dtype)
    return t.to(like.device)


class CheckpointManager:
    def __init__(self, directory: str, *, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: threading.Thread | None = None

    # -- write ---------------------------------------------------------

    def save(self, state, step: int, *, blocking: bool = False) -> None:
        self.wait()
        flat = flatten_with_paths(state)
        keys = ["/".join(path) for path, _ in flat]
        leaves = [_to_numpy(leaf) for _, leaf in flat]

        def _write():
            tmp = os.path.join(self.dir, f"{step}.tmp")
            final = os.path.join(self.dir, str(step))
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
            np.savez(os.path.join(tmp, "arrays.npz"),
                     **{f"a{i}": a for i, a in enumerate(leaves)})
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump({"step": step, "keys": keys}, f)
            shutil.rmtree(final, ignore_errors=True)
            os.replace(tmp, final)                      # atomic commit
            self._gc()

        if blocking:
            _write()
        else:
            self._thread = threading.Thread(target=_write, daemon=True)
            self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self) -> None:
        steps = self._steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, str(s)),
                          ignore_errors=True)

    # -- read ----------------------------------------------------------

    def _steps(self):
        out = []
        for name in os.listdir(self.dir):
            if name.isdigit() and os.path.exists(
                    os.path.join(self.dir, name, "manifest.json")):
                out.append(int(name))
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self._steps()
        return steps[-1] if steps else None

    def restore(self, like, step: int | None = None):
        """Restore into the structure of ``like``, each leaf on its
        device and in its dtype.  Returns ``(state, step)``."""
        self.wait()
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        path = os.path.join(self.dir, str(step))
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        like_flat = flatten_with_paths(like)
        if len(manifest["keys"]) != len(like_flat):
            raise ValueError(f"checkpoint {path} has {len(manifest['keys'])} "
                             f"leaves, the state {len(like_flat)}")
        with np.load(os.path.join(path, "arrays.npz")) as data:
            leaves = [_from_numpy(data[f"a{i}"], leaf)
                      for i, (_, leaf) in enumerate(like_flat)]
        return unflatten_like(like, leaves), manifest["step"]
