"""Train-step construction: gradient accumulation and the fault-tolerant
driver loop (counterpart of ``repro/training/train.py``).

:func:`build_train_step` is the reference's single-program step in eager
PyTorch: ``torch.autograd.grad`` of ``model.loss`` over the parameter
leaves (mean over ``microbatches`` sequential slices of the batch), then
:func:`~repro_torch.training.optimizer.adamw_update`.  The step is
functional: it returns a new :class:`TrainState` and leaves the one it was
given as it was, which the driver's replay from its initial state needs.
Under a sharding context the parameters are DTensors (laid out by
:func:`state_specs`): the gradients come back in their layouts (the
data-parallel and tensor-parallel sums done) and AdamW runs on the
shards.

:func:`build_train_step_compressed` is the cross-pod step of a multi-pod
mesh: each pod computes gradients on its sub-batch under an inner
context on its own ``data × model`` submesh (``batch`` → ``data``), the
pods sync them through the int8 error-feedback compressor
(:func:`~repro_torch.training.compression.ef_compress_sync` over the
``pod`` group), the loss is averaged over pods, then AdamW runs.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch
import torch.distributed as dist

from repro_torch.distribution.sharding import (ShardCtx, Spec, current_ctx,
                                               full, is_dtensor,
                                               param_sharding_tree,
                                               plain_as_replicated,
                                               sharding_ctx)
from repro_torch.training.compression import (ef_compress_sync,
                                              init_error_feedback)
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


def state_specs(model, *, compressed: bool = False) -> TrainState:
    """The specs of a :class:`TrainState` under the active context."""
    ps = model.param_specs()
    return TrainState(params=ps, opt=OptState(m=ps, v=ps, step=Spec()),
                      err=ps if compressed else None)


def shard_train_state(state: TrainState, model, ctx) -> TrainState:
    """``state`` (full tensors, the same on every rank) laid out by
    :func:`state_specs` on the context's mesh (the compressed step's state
    on each pod's ``data × model`` submesh); the step count stays a plain
    tensor."""
    if ctx.pod_axis is not None and state.err is not None:
        ctx = _inner(ctx)
    with sharding_ctx(ctx):
        specs = state_specs(model, compressed=state.err is not None)
    dist_ = lambda t, s: param_sharding_tree(t, s, ctx.mesh)  # noqa: E731
    return TrainState(
        dist_(state.params, specs.params),
        OptState(dist_(state.opt.m, specs.opt.m),
                 dist_(state.opt.v, specs.opt.v), state.opt.step),
        None if state.err is None else dist_(state.err, specs.err))


def _inner(ctx) -> ShardCtx:
    """A multi-pod context's inner context: one pod's ``data × model``
    submesh, with ``batch`` over ``data``."""
    names = tuple(ctx.mesh.mesh_dim_names)
    rules = dict(ctx.rules)
    rules["batch"] = "data"
    return ShardCtx(mesh=ctx.mesh[tuple(a for a in names
                                        if a != ctx.pod_axis)],
                    rules=rules, dp_axes=("data",), tp_axis=ctx.tp_axis,
                    pod_axis=None)


def _as_param(g, p):
    """A gradient in its parameter's layout: a DTensor gradient's pending
    sums (``Partial``) are reduced and its shards laid out as ``p``'s."""
    if is_dtensor(g):
        return g.redistribute(p.device_mesh, p.placements)
    return g


def value_and_grad(loss_fn, params, tokens, labels):
    """``(loss, grads)`` of ``loss_fn`` at ``params``; a leaf the loss
    does not read gets a zero gradient, as in JAX."""
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    with torch.enable_grad():
        loss = loss_fn(unflatten_like(params, leaves), tokens, labels)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else _as_param(g, p)
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
    acc = [torch.zeros_like(p, dtype=torch.float32)
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
        # a plain tensor beside a sharded one (a step count, a learning
        # rate) is the same full value on every rank
        with plain_as_replicated():
            loss, grads = _accum_grads(model.loss, state.params, tokens,
                                       labels, microbatches)
            new_p, new_opt, metrics = adamw_update(opt_cfg, state.params,
                                                   grads, state.opt)
        metrics["loss"] = full(loss)
        return TrainState(new_p, new_opt, state.err), metrics

    return train_step


class CompressedStepError(ValueError):
    """The compressed step was asked for without a multi-pod context."""


def build_train_step_compressed(model, opt_cfg: OptCfg, *,
                                microbatches: int = 1):
    """Cross-pod int8 error-feedback gradient sync (multi-pod meshes;
    reference ``train.py:88-154``).

    Needs an active sharding context whose mesh has a ``pod`` axis.  The
    state is replicated over pods and laid out on each pod's ``data ×
    model`` submesh; the batch splits over pods on its leading dim (every
    rank is given the whole batch and takes its pod's rows).  The loss is
    averaged per pod; the compressed sum then averages over pods, so the
    gradients match the uncompressed step up to quantization.
    """
    ctx = current_ctx()
    if ctx is None or ctx.pod_axis is None:
        raise CompressedStepError(
            "the compressed step needs a multi-pod mesh context (a mesh "
            "with a 'pod' axis, e.g. --mesh multi)")
    pod, mesh = ctx.pod_axis, ctx.mesh
    n_pod = mesh.size(list(mesh.mesh_dim_names).index(pod))
    pod_idx = mesh.get_local_rank(pod)
    group = mesh.get_group(pod)
    # inside a pod the model never names the pod axis: batch parallelism
    # continues over the in-pod data axis
    inner_ctx = _inner(ctx)

    def train_step(state: TrainState, tokens, labels):
        b = tokens.shape[0] // n_pod
        rows = slice(pod_idx * b, (pod_idx + 1) * b)
        with sharding_ctx(inner_ctx), plain_as_replicated():
            loss, grads = _accum_grads(model.loss, state.params,
                                       tokens[rows], labels[rows],
                                       microbatches)
            grads, new_err = ef_compress_sync(grads, state.err, group)
            loss = full(loss).clone()
            dist.all_reduce(loss, group=group)
            new_p, new_opt, metrics = adamw_update(opt_cfg, state.params,
                                                   grads, state.opt)
        metrics["loss"] = loss / n_pod
        return TrainState(new_p, new_opt, new_err), metrics

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
