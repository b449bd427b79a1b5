"""WKV-6 entry point: the kernel on the card, the plain chunked form for
tensors on the CPU.

Seq-major ``[B,T,H,K]`` API, as the reference's ``ops.wkv6``, with the
models' optional carry-in state; the kernel reads that layout through
strides, so nothing is transposed.
"""
from __future__ import annotations

from . import kernel
from .ref import wkv6_chunked_ref


def wkv6(r, k, v, lw, u, s0=None, *, chunk: int = 32):
    """r, k, v, lw: ``[B,T,H,K]``; u: ``[H,K]``; s0: ``[B,H,K,K]`` f32 or
    ``None`` → ``(y [B,T,H,K], state [B,H,K,K])``.

    CPU tensors take the plain chunked form; CUDA tensors launch the
    kernel, which raises on anything it does not take.
    """
    if r.device.type == "cpu":
        return wkv6_chunked_ref(r, k, v, lw, u, s0, chunk)
    return kernel.wkv6(r, k, v, lw, u, s0, chunk=chunk)
