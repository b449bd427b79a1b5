"""Deterministic synthetic LM data pipeline (counterpart of
``repro/data/pipeline.py``).

Two generators, numpy on the host and bit-equal to the reference's:

* ``random_batch`` — uniform tokens (throughput benchmarks, dry-runs).
* ``lcg_batch`` — a learnable affine-recurrence language (``t_{i+1} =
  (a·t_i + b) mod V`` with per-sequence (a, b) drawn from a small set),
  so end-to-end training demos show a decreasing loss.

Batches are keyed by step index — replaying a step after a restart
yields bit-identical data (required by the fault-tolerant driver).
``place`` puts a batch on a device; there is no sharding yet.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device


def random_batch(step: int, batch: int, seq: int, vocab: int, seed: int = 0):
    rng = np.random.default_rng((seed, step))
    tokens = rng.integers(0, vocab, (batch, seq + 1), dtype=np.int32)
    return tokens[:, :-1], tokens[:, 1:]


_COEFFS = [(5, 3), (7, 11), (13, 5), (3, 17)]


def lcg_batch(step: int, batch: int, seq: int, vocab: int, seed: int = 0):
    rng = np.random.default_rng((seed, step))
    ab = rng.integers(0, len(_COEFFS), batch)
    t0 = rng.integers(0, vocab, batch)
    toks = np.empty((batch, seq + 1), dtype=np.int64)
    toks[:, 0] = t0
    for i, (a, b) in enumerate(_COEFFS):
        sel = ab == i
        for t in range(seq):
            toks[sel, t + 1] = (a * toks[sel, t] + b) % vocab
    toks = toks.astype(np.int32)
    return toks[:, :-1], toks[:, 1:]


def place(tokens, labels, device=None):
    """A host batch as int32 tensors on ``device`` (``None`` = CUDA)."""
    dev = resolve_device(device)
    return (torch.from_numpy(np.ascontiguousarray(tokens)).to(dev),
            torch.from_numpy(np.ascontiguousarray(labels)).to(dev))


def make_data_iter(kind: str, batch: int, seq: int, vocab: int,
                   seed: int = 0, *, device=None):
    """``data_iter(step) → (tokens, labels)`` on ``device`` (``None`` =
    CUDA) for ``kind`` ``"random"`` or ``"lcg"``."""
    gen = {"random": random_batch, "lcg": lcg_batch}[kind]
    dev = resolve_device(device)

    def data_iter(step: int):
        return place(*gen(step, batch, seq, vocab, seed), dev)

    return data_iter
