"""WKV-6 entry point: the kernel on the card, the plain chunked form for
tensors on the CPU.

Seq-major ``[B,T,H,K]`` API, as the reference's ``ops.wkv6``, with the
models' optional carry-in state; the kernel reads that layout through
strides, so nothing is transposed.  Under autograd the call goes through
:class:`~repro_torch.kernels.autograd.ScanGrad`: the same forward, the
gradient of the plain chunked form (the reference trains through that
form and has no backward kernel).
"""
from __future__ import annotations

from repro_torch.kernels.autograd import ScanGrad, wants_grad

from . import kernel
from .ref import wkv6_chunked_ref


#: devices whose tensors take the plain chunked form: the CPU, and
#: ``meta``, whose tensors hold only shapes (the dry-run census traces
#: the scan there; nothing runs)
_PLAIN = ("cpu", "meta")


def wkv6(r, k, v, lw, u, s0=None, *, chunk: int = 32):
    """r, k, v, lw: ``[B,T,H,K]``; u: ``[H,K]``; s0: ``[B,H,K,K]`` f32 or
    ``None`` → ``(y [B,T,H,K], state [B,H,K,K])``.

    CPU and meta tensors take the plain chunked form; CUDA tensors launch the
    kernel, which raises on anything it does not take.
    """
    forward = wkv6_chunked_ref if r.device.type in _PLAIN else kernel.wkv6
    if wants_grad(r, k, v, lw, u, s0):
        return ScanGrad.apply(forward, wkv6_chunked_ref, chunk, r, k, v, lw,
                              u, s0)
    return forward(r, k, v, lw, u, s0, chunk=chunk)
