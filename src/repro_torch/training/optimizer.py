"""AdamW with global-norm clipping and a warmup+cosine schedule
(counterpart of ``repro/training/optimizer.py``).

Moments are f32 tensors on the parameters' devices, over the port's
parameter tree.  Decoupled weight decay falls on the reference's
matrices, the leaves it holds with ``ndim >= 2``.  The reference stacks
every leaf under ``"layers"`` on a leading ``L`` axis and the port holds
one dict per layer, so a leaf there counts that axis too: a per-layer
norm scale (``[D]`` here, ``[L, D]`` there) is decayed in both.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch

from repro_torch.distribution.sharding import full
from repro_torch.training.tree import (tree_leaves, tree_map,
                                      tree_map_with_path, unflatten_like)


@dataclasses.dataclass(frozen=True)
class OptCfg:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


class OptState(NamedTuple):
    m: Any
    v: Any
    step: torch.Tensor       # int32, 0-d, on the parameters' device


def init_opt_state(params) -> OptState:
    """f32 zero moments in the parameters' layouts (a DTensor parameter's
    moments are DTensors laid out as it is)."""
    zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)  # noqa: E731
    dev = tree_leaves(params)[0].device
    return OptState(m=tree_map(zeros, params), v=tree_map(zeros, params),
                    step=torch.zeros((), dtype=torch.int32, device=dev))


def schedule(cfg: OptCfg, step) -> torch.Tensor:
    """The learning rate at ``step`` (an int or an integer tensor), f32."""
    step = torch.as_tensor(step).float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    frac = cfg.min_lr_frac + (1.0 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32.  The port sums per
    layer where the reference sums per stacked leaf: the same terms in
    another order (tests: within 1e-6 relative).  A sharded leaf's sum is
    its full sum, the same on every rank."""
    return torch.sqrt(torch.stack(
        [full(torch.sum(x.float() ** 2)) for x in tree_leaves(tree)]).sum())


def decayed(path: tuple, p: torch.Tensor) -> bool:
    """Whether the reference decays this leaf: ``ndim >= 2`` counted on its
    stacked layout (a leaf under ``"layers"`` has one more axis there)."""
    return p.dim() + (path[:1] == ("layers",)) >= 2


def adamw_update(cfg: OptCfg, params, grads, opt: OptState):
    """Returns ``(new_params, new_opt, metrics)``; nothing is updated in
    place."""
    gnorm = global_norm(grads)
    # a tensor numerator: torch's ``number / tensor`` is a reciprocal
    scale = torch.clamp(torch.full_like(gnorm, cfg.clip_norm)
                        / torch.clamp(gnorm, min=1e-9), max=1.0)
    step = opt.step + 1
    lr = schedule(cfg, step)
    one = torch.ones((), dtype=torch.float32, device=gnorm.device)
    b1c = 1.0 - torch.pow(one * cfg.b1, step.float())
    b2c = 1.0 - torch.pow(one * cfg.b2, step.float())

    def upd(path, p, g, m, v):
        g = g.float() * scale
        m = cfg.b1 * m + (1.0 - cfg.b1) * g
        v = cfg.b2 * v + (1.0 - cfg.b2) * g * g
        delta = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
        if decayed(path, p):                 # decoupled decay on matrices
            delta = delta + cfg.weight_decay * p.float()
        return (p.float() - lr * delta).to(p.dtype), m, v

    out = []
    tree_map_with_path(lambda path, *x: out.append(upd(path, *x)), params,
                       grads, opt.m, opt.v)
    new = [unflatten_like(params, [o[i] for o in out]) for i in range(3)]
    return new[0], OptState(new[1], new[2], step), {
        "grad_norm": gnorm, "lr": lr}
