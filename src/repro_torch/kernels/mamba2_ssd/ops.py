"""SSD entry point: the kernel on the card, the plain chunked form for
tensors on the CPU.

Seq-major API, as the reference's ``ops.ssd``, with the models' optional
carry-in state; the kernel reads the model's views through strides, so
nothing is copied.  Under autograd the call goes through
:class:`~repro_torch.kernels.autograd.ScanGrad`: the same forward, the
gradient of the plain chunked form (the reference trains through that
form and has no backward kernel).
"""
from __future__ import annotations

from repro_torch.kernels.autograd import ScanGrad, wants_grad

from . import kernel
from .ref import ssd_chunked_ref


#: devices whose tensors take the plain chunked form: the CPU, and
#: ``meta``, whose tensors hold only shapes (the dry-run census traces
#: the scan there; nothing runs)
_PLAIN = ("cpu", "meta")


def ssd(x, dt_h, bmat, cmat, a, h0=None, *, chunk: int = 128):
    """x: ``[B,T,H,P]``; dt_h: ``[B,T,H]``; bmat, cmat: ``[B,T,N]``; a:
    ``[H]``; h0: ``[B,H,P,N]`` f32 or ``None`` → ``(y [B,T,H,P], state
    [B,H,P,N])``.

    CPU and meta tensors take the plain chunked form; CUDA tensors launch the
    kernels (three passes), which raise on anything they do not take.
    """
    forward = ssd_chunked_ref if x.device.type in _PLAIN else kernel.ssd
    if wants_grad(x, dt_h, bmat, cmat, a, h0):
        return ScanGrad.apply(forward, ssd_chunked_ref, chunk, x, dt_h, bmat,
                              cmat, a, h0)
    return forward(x, dt_h, bmat, cmat, a, h0, chunk=chunk)
