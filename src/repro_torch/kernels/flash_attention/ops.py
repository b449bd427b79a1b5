"""Causal flash attention entry point: the kernel on the card, its plain
version for tensors on the CPU.

Seq-major ``[B,S,H,Dh]`` API, as the reference's ``ops.flash_attention``
(which provides causal attention only); the kernel reads that layout
through strides, so nothing is transposed.
"""
from __future__ import annotations

from repro_torch.kernels.autograd import refuse_grad

from . import kernel
from .ref import flash_attention_ref


def flash_attention(q, k, v):
    """Causal attention.  q: ``[B,S,H,Dh]``; k, v: ``[B,S,KV,Dh]`` →
    ``[B,S,H,Dh]``.

    CPU tensors take the plain version; CUDA tensors launch the kernel,
    which raises on anything it does not take.  Neither has a gradient,
    as in the reference: an input that requires one raises
    ``NotImplementedError``.
    """
    refuse_grad("flash_attention", q, k, v)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v)
    return kernel.flash_attention(q, k, v)
