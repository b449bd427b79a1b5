"""Decode attention entry point: the kernel on the card, its plain version
for tensors on the CPU.

Seq-major cache API, as the reference's ``ops.decode_attention``; the
kernel reads the cache in place through strides, so nothing is transposed.
"""
from __future__ import annotations

from repro_torch.kernels.autograd import refuse_grad

from . import kernel
from .ref import decode_attention_ref


def decode_attention(q, k, v, pos):
    """q: ``[B,H,Dh]``; k, v: ``[B,S,KV,Dh]``; pos: ``[B]`` int32 →
    ``[B,H,Dh]``.

    CPU tensors take the plain version; CUDA tensors launch the kernel,
    which raises on anything it does not take.  Neither has a gradient,
    as in the reference: an input that requires one raises
    ``NotImplementedError``.
    """
    refuse_grad("decode_attention", q, k, v)
    if q.device.type == "cpu":
        return decode_attention_ref(q, k, v, pos)
    return kernel.decode_attention(q, k, v, pos)
