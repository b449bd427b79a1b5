"""ctypes binding of the ``flash_attention`` CUDA kernel.

The kernel (``src/repro_torch/csrc/flash_attention.cu``) replaces the
Pallas TPU kernel ``repro/kernels/flash_attention/kernel.py``
(``flash_attention_hm``).  :func:`flash_attention` checks its inputs,
allocates the output, launches on PyTorch's current stream and raises if
the launch was refused.  ``flash_attention.launches`` counts its launches.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import _build

HEAD_DIMS = (32, 64, 80, 128, 256)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: 64-row query tiles on CUDA's y grid axis (at most 65535)
MAX_SEQ = 65535 * 64


class UnsupportedShapeError(ValueError):
    """The kernel is not built for this head dim, dtype, head grouping or
    alignment."""


@functools.cache
def _launcher():
    fn = _build.load("flash_attention").flash_attention_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 \
        + [ctypes.c_void_p, ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def check_inputs(name: str, q, kvs, *, q_ndim: int):
    """Shared checks of the attention kernels: one CUDA device, one
    supported dtype, contiguous last dim, a supported head dim."""
    for x in (q, *kvs):
        if not x.is_cuda or x.device != q.device:
            raise ValueError(f"{name}: every input must be a CUDA tensor on "
                             f"{q.device}, got one on {x.device}")
        if x.dtype != q.dtype:
            raise ValueError(f"{name}: inputs must share one dtype, got "
                             f"{q.dtype} and {x.dtype}")
        if x.stride(-1) != 1:
            raise ValueError(f"{name}: the head dim must be contiguous, got "
                             f"strides {x.stride()}")
    if q.dtype not in DTYPES:
        raise UnsupportedShapeError(f"{name}: dtype {q.dtype} is not built; "
                                    f"choose from {tuple(DTYPES)}")
    if q.dim() != q_ndim or any(x.dim() != 4 for x in kvs):
        raise ValueError(f"{name}: bad ranks {q.dim()}, "
                         f"{[x.dim() for x in kvs]}")
    if q.shape[-1] not in HEAD_DIMS:
        raise UnsupportedShapeError(f"{name}: head dim {q.shape[-1]} is not "
                                    f"built; choose from {HEAD_DIMS}")


def check_aligned(name: str, xs):
    """The contract of the kernels' 16-byte copies (``cp.async``): every
    data pointer 16-byte aligned and every (b, s, h) stride a multiple of
    8 elements."""
    for x in xs:
        if x.data_ptr() % 16 or any(st % 8 for st in x.stride()[:3]):
            raise UnsupportedShapeError(
                f"{name}: needs 16-byte aligned data and (b, s, h) strides "
                f"that are multiples of 8 elements, got data at "
                f"{x.data_ptr():#x} with strides {x.stride()}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """Causal attention.  q ``[B,S,H,Dh]``, k/v ``[B,S,KV,Dh]`` on one CUDA
    device, (b, s, h) strides of the caller's choosing, head dim
    contiguous → o ``[B,S,H,Dh]`` (contiguous, q's dtype).  The bf16
    kernel copies rows in 16-byte pieces, so there the data must be
    16-byte aligned and the strides multiples of 8 elements."""
    check_inputs("flash_attention", q, (k, v), q_ndim=4)
    if q.dtype == torch.bfloat16:
        check_aligned("flash_attention", (q, k, v))
    B, S, H, Dh = q.shape
    KV = k.shape[2]
    if k.shape != (B, S, KV, Dh) or v.shape != k.shape:
        raise ValueError(f"flash_attention: k and v must be [B={B}, S={S}, "
                         f"KV, Dh={Dh}], got {tuple(k.shape)} and "
                         f"{tuple(v.shape)}")
    if KV < 1 or H % KV != 0:
        raise UnsupportedShapeError(f"flash_attention: H={H} is not a "
                                    f"multiple of KV={KV}")
    if not 1 <= S <= MAX_SEQ or B > 65535 or H > 65535:
        raise UnsupportedShapeError(f"flash_attention: needs 1 <= S <= "
                                    f"{MAX_SEQ} and B, H <= 65535, got "
                                    f"{tuple(q.shape)}")
    o = torch.empty((B, S, H, Dh), dtype=q.dtype, device=q.device)
    strides = (ctypes.c_longlong * 12)(
        *(x.stride(i) for x in (q, k, v, o) for i in range(3)))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _launcher()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                          o.data_ptr(), DTYPES[q.dtype], B, S, H, KV, Dh,
                          ctypes.addressof(strides), 1.0 / math.sqrt(Dh),
                          stream)
    if err != 0:
        raise RuntimeError(f"flash_attention: kernel launch failed with "
                           f"CUDA error {err}")
    flash_attention.launches += 1
    return o


flash_attention.launches = 0
