"""Train-step construction: gradient accumulation and the fault-tolerant
driver loop (counterpart of ``repro/training/train.py``).

:func:`build_train_step` is the reference's single-program step in eager
PyTorch: ``torch.autograd.grad`` of ``model.loss`` over the parameter
leaves (mean over ``microbatches`` sequential slices of the batch), then
:func:`~repro_torch.training.optimizer.adamw_update`.  The step is
functional: it returns a new :class:`TrainState` and leaves the one it was
given as it was, which the driver's replay from its initial state needs.
The cross-pod compressed step (``build_train_step_compressed``) waits for
the port of ``repro.distribution.sharding``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from repro_torch.training.compression import init_error_feedback
from repro_torch.training.optimizer import (OptCfg, OptState, adamw_update,
                                            init_opt_state)
from repro_torch.training.tree import tree_leaves, unflatten_like


class TrainState(NamedTuple):
    params: Any
    opt: OptState
    err: Any | None          # error-feedback buffers (compressed sync only)


def init_train_state(model, gen: torch.Generator, *,
                     compressed: bool = False) -> TrainState:
    params = model.init(gen)
    return TrainState(params=params, opt=init_opt_state(params),
                      err=init_error_feedback(params) if compressed
                      else None)


def value_and_grad(loss_fn, params, tokens, labels):
    """``(loss, grads)`` of ``loss_fn`` at ``params``; a leaf the loss
    does not read gets a zero gradient, as in JAX."""
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    with torch.enable_grad():
        loss = loss_fn(unflatten_like(params, leaves), tokens, labels)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    return loss.detach(), unflatten_like(params, grads)


def _accum_grads(loss_fn, params, tokens, labels, microbatches: int):
    """Mean loss/grads over ``microbatches`` sequential slices of batch."""
    if microbatches <= 1:
        return value_and_grad(loss_fn, params, tokens, labels)
    B = tokens.shape[0]
    if B % microbatches:
        raise ValueError(f"batch {B} does not split into {microbatches} "
                         f"microbatches")
    mb = B // microbatches
    loss = torch.zeros((), dtype=torch.float32, device=tokens.device)
    acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
           for p in tree_leaves(params)]
    for i in range(microbatches):
        sl = slice(i * mb, (i + 1) * mb)
        l_i, g_i = value_and_grad(loss_fn, params, tokens[sl], labels[sl])
        loss = loss + l_i
        for a, g in zip(acc, tree_leaves(g_i)):
            a.add_(g)
    inv = 1.0 / microbatches
    return loss * inv, unflatten_like(params, [a * inv for a in acc])


def build_train_step(model, opt_cfg: OptCfg, *, microbatches: int = 1):
    """Standard train step: ``(state, tokens, labels) → (state, metrics)``
    with ``metrics`` ``{"loss", "grad_norm", "lr"}`` (0-d tensors)."""

    def train_step(state: TrainState, tokens, labels):
        loss, grads = _accum_grads(model.loss, state.params, tokens, labels,
                                   microbatches)
        new_p, new_opt, metrics = adamw_update(opt_cfg, state.params, grads,
                                               state.opt)
        metrics["loss"] = loss
        return TrainState(new_p, new_opt, state.err), metrics

    return train_step


# ---------------------------------------------------------------------------
# Fault-tolerant driver (checkpoint/restart around a step function)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class RunReport:
    steps_done: int
    restarts: int
    final_loss: float
    losses: list


def run_with_restarts(step_fn, state, data_iter, *, n_steps: int,
                      ckpt_mgr=None, ckpt_every: int = 50,
                      max_restarts: int = 3,
                      failure_hook=None) -> tuple[Any, RunReport]:
    """Run ``n_steps``, checkpointing every ``ckpt_every``; on an exception
    restore the last checkpoint and continue (node-failure semantics: any
    step may die; progress resumes from the last durable state).

    ``failure_hook(step)`` (tests) may raise to inject failures.
    ``data_iter(step)`` must be resumable by step index so replayed steps
    see identical data.
    """
    restarts = 0
    losses = []
    step = 0
    state0 = state                       # durable initial state (step 0)
    if ckpt_mgr is not None and ckpt_mgr.latest_step() is not None:
        state, step = ckpt_mgr.restore(state)
    while step < n_steps:
        try:
            if failure_hook is not None:
                failure_hook(step)
            tokens, labels = data_iter(step)
            state, metrics = step_fn(state, tokens, labels)
            losses.append(float(metrics["loss"]))
            step += 1
            if ckpt_mgr is not None and step % ckpt_every == 0:
                ckpt_mgr.save(state, step)
        except Exception:                                  # noqa: BLE001
            restarts += 1
            if restarts > max_restarts:
                raise
            if ckpt_mgr is None:
                raise
            if ckpt_mgr.latest_step() is None:
                state, step = state0, 0   # failed before first checkpoint
            else:
                state, step = ckpt_mgr.restore(state)
    if ckpt_mgr is not None:
        ckpt_mgr.save(state, step)
        ckpt_mgr.wait()
    return state, RunReport(steps_done=step, restarts=restarts,
                            final_loss=losses[-1] if losses else float("nan"),
                            losses=losses)
