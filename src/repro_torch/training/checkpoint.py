"""Step-atomic checkpointing (counterpart of
``repro/training/checkpoint.py``, the reference's on-disk layout).

Format: one directory per step containing ``arrays.npz`` (the flattened
leaves as ``a0 … aN``) and ``manifest.json`` (``{"step", "keys"}``, each
key the leaf's path joined by ``/``); written to ``<step>.tmp`` and
committed with an atomic ``os.replace`` so a crash mid-save never
corrupts the latest checkpoint.  bfloat16 leaves, which numpy has no type
for, are stored by their bits (``uint16``) and restored into ``like``'s
dtype.

Sharded states: a save of DTensors gathers every leaf's full value on
every rank (a collective each rank joins), then rank 0 alone writes it,
and every rank waits for the commit.  A restore places each leaf as
``sharding_tree`` says (a tree of
:class:`~repro_torch.distribution.sharding.NamedSharding`, possibly on
another mesh than the save's: the elastic re-mesh), else as the matching
leaf of ``like`` (its mesh and placements, or its device), in its dtype.

The copy to the host runs on the calling thread (so the saved state is
the state at ``save``); the npz write runs on a background thread and
``wait()`` joins it (on a multi-rank world the write blocks).
"""
from __future__ import annotations

import json
import os
import shutil
import threading

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.distribution.sharding import (NamedSharding, distribute,
                                               full, is_dtensor, spec_of)
from repro_torch.training.tree import (flatten_with_paths, tree_leaves,
                                       unflatten_like)


def _world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = full(t.detach()).to("cpu", copy=True)
    if t.dtype == torch.bfloat16:                  # carry the bits
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _from_numpy(a: np.ndarray, like: torch.Tensor,
                sh: NamedSharding | None = None) -> torch.Tensor:
    if like.dtype == torch.bfloat16 and a.dtype == np.uint16:
        t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a, copy=True)).to(like.dtype)
    if sh is None and is_dtensor(like):
        sh = NamedSharding(like.device_mesh, spec_of(like))
    if sh is None:
        return t.to(like.device)
    return distribute(t.to(sh.mesh.device_type), sh)


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
        if _world() > 1:
            # every rank gathered; rank 0 writes; all wait for the commit
            if dist.get_rank() == 0:
                self._write(leaves, keys, step)
            dist.barrier()
            return

        if blocking:
            self._write(leaves, keys, step)
        else:
            self._thread = threading.Thread(
                target=self._write, args=(leaves, keys, step), daemon=True)
            self._thread.start()

    def _write(self, leaves, keys, step: int) -> None:
        tmp = os.path.join(self.dir, f"{step}.tmp")
        final = os.path.join(self.dir, str(step))
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        np.savez(os.path.join(tmp, "arrays.npz"),
                 **{f"a{i}": a for i, a in enumerate(leaves)})
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump({"step": step, "keys": keys}, f)
        shutil.rmtree(final, ignore_errors=True)
        os.replace(tmp, final)                          # atomic commit
        self._gc()

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

    def restore(self, like, step: int | None = None, *,
                sharding_tree=None):
        """Restore into the structure of ``like``, each leaf in its dtype:
        laid out by ``sharding_tree`` (same structure; possibly another
        mesh: the elastic re-mesh), else as ``like``'s leaf.  Returns
        ``(state, step)``."""
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
        shs = (tree_leaves(sharding_tree) if sharding_tree is not None
               else [None] * len(like_flat))
        with np.load(os.path.join(path, "arrays.npz")) as data:
            leaves = [_from_numpy(data[f"a{i}"], leaf, sh)
                      for i, ((_, leaf), sh) in enumerate(zip(like_flat,
                                                              shs))]
        return unflatten_like(like, leaves), manifest["step"]
