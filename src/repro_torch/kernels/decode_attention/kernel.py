"""ctypes binding of the ``decode_attention`` CUDA kernel.

The kernel (``src/repro_torch/csrc/decode_attention.cu``) replaces the
Pallas TPU kernel ``repro/kernels/decode_attention/kernel.py``
(``decode_attention_hm``).  :func:`decode_attention` checks its inputs,
allocates the output, launches on PyTorch's current stream and raises if
the launch was refused.  ``decode_attention.launches`` counts its
launches.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.kernel import (
    DTYPES, UnsupportedShapeError, check_inputs)

#: query heads per KV head the kernel keeps in shared memory
MAX_GROUP = 64


@functools.cache
def _launcher():
    fn = _build.load("decode_attention").decode_attention_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 \
        + [ctypes.c_void_p, ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     pos: torch.Tensor):
    """q ``[B,H,Dh]``; k/v ``[B,S_max,KV,Dh]`` (the cache, read in place
    through its strides); pos ``[B]`` int32 in ``[0, S_max)`` → o
    ``[B,H,Dh]`` (contiguous, q's dtype).  ``pos`` stays on the device:
    the range is the caller's contract, as the cache's capacity is."""
    check_inputs("decode_attention", q, (k, v), q_ndim=3)
    B, H, Dh = q.shape
    S, KV = k.shape[1], k.shape[2]
    if k.shape != (B, S, KV, Dh) or v.shape != k.shape:
        raise ValueError(f"decode_attention: k and v must be [B={B}, S, KV, "
                         f"Dh={Dh}], got {tuple(k.shape)} and "
                         f"{tuple(v.shape)}")
    if KV < 1 or H % KV != 0 or H // KV > MAX_GROUP:
        raise UnsupportedShapeError(
            f"decode_attention: needs H % KV == 0 and H / KV <= "
            f"{MAX_GROUP}, got H={H}, KV={KV}")
    if B > 65535:
        raise UnsupportedShapeError(f"decode_attention: B={B} > 65535")
    if pos.shape != (B,) or pos.dtype != torch.int32 or pos.device != \
            q.device or not pos.is_contiguous():
        raise ValueError(f"decode_attention: pos must be a contiguous [B={B}]"
                         f" int32 tensor on {q.device}, got "
                         f"{tuple(pos.shape)} {pos.dtype} on {pos.device}")
    o = torch.empty((B, H, Dh), dtype=q.dtype, device=q.device)
    strides = (ctypes.c_longlong * 10)(
        q.stride(0), q.stride(1), *k.stride()[:3], *v.stride()[:3],
        o.stride(0), o.stride(1))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _launcher()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                          pos.data_ptr(), o.data_ptr(), DTYPES[q.dtype], B,
                          S, H, KV, Dh, ctypes.addressof(strides),
                          1.0 / math.sqrt(Dh), stream)
    if err != 0:
        raise RuntimeError(f"decode_attention: kernel launch failed with "
                           f"CUDA error {err}")
    decode_attention.launches += 1
    return o


decode_attention.launches = 0
