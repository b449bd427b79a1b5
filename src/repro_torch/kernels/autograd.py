"""Gradients through the kernels' entry points.

The reference trains its recurrent models through the plain chunked
scans and has no backward kernel for either (``src/repro`` defines no
``custom_vjp``); its flash attention refuses a gradient.  The port keeps
those rules with a kernel in the forward:

* :class:`ScanGrad` runs a scan's forward (the kernel on the card) and
  takes its gradient as autograd through the plain chunked form,
  recomputed from the saved inputs in the backward;
* :func:`refuse_grad` raises where the attention kernels are asked for a
  gradient.
"""
from __future__ import annotations

import torch


def wants_grad(*xs) -> bool:
    """Grad mode is on and an input (``None`` skipped) requires a
    gradient."""
    return torch.is_grad_enabled() and any(
        x is not None and x.requires_grad for x in xs)


class ScanGrad(torch.autograd.Function):
    """``ScanGrad.apply(forward, plain, chunk, *inputs)`` → ``(y, state)``
    of ``forward(*inputs, chunk=chunk)``.

    The backward recomputes ``plain(*inputs, chunk=chunk)`` under
    ``torch.enable_grad()`` and returns ``torch.autograd.grad`` of it, so
    the gradient is autograd through the plain form bit for bit.  An input
    may be ``None`` (no carry-in state).
    """

    @staticmethod
    def forward(ctx, forward, plain, chunk, *inputs):
        ctx.plain, ctx.chunk = plain, chunk
        ctx.save_for_backward(*inputs)
        return forward(*inputs, chunk=chunk)

    @staticmethod
    def backward(ctx, *grad_outs):
        need = ctx.needs_input_grad[3:]
        with torch.enable_grad():
            xs = [x if x is None else x.detach().requires_grad_(n)
                  for x, n in zip(ctx.saved_tensors, need)]
            outs = ctx.plain(*xs, chunk=ctx.chunk)
            wrt = [x for x, n in zip(xs, need) if n]
            grads = iter(torch.autograd.grad(outs, wrt, grad_outs,
                                             allow_unused=True))
        return (None, None, None,
                *(next(grads) if n else None for n in need))


def refuse_grad(name: str, *xs) -> None:
    """Raise ``NotImplementedError`` when ``name``'s inputs ask for a
    gradient: the attention kernels have none, as in the reference."""
    if wants_grad(*xs):
        raise NotImplementedError(
            f"{name}: attn_impl='pallas' has no gradient (the reference's "
            f"kernel refuses one too); train with attn_impl='xla_chunked'")
