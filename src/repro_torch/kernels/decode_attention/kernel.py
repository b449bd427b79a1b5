"""ctypes binding of the ``decode_attention`` CUDA kernels.

The split-KV kernel and its combine kernel
(``src/repro_torch/csrc/decode_attention.cu``) replace the Pallas TPU
kernel ``repro/kernels/decode_attention/kernel.py``
(``decode_attention_hm``).  :func:`decode_attention` checks its inputs,
picks the split on the host (:func:`split_rows`, from the shapes alone:
``pos`` stays on the device), allocates the output and the f32 partials,
launches both kernels on PyTorch's current stream and raises if a launch
was refused.  ``decode_attention.launches`` counts its calls (two device
launches each).
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.kernel import (
    DTYPES, UnsupportedShapeError, check_aligned, check_inputs)

#: query heads per KV head the kernel keeps in shared memory
MAX_GROUP = 64
#: streaming multiprocessors of an H100 SXM
N_SMS = 132
#: blocks the split-KV grid aims for: four per SM, so that a prefix that
#: ends well before S_max still leaves about two per SM with rows to read
TARGET_BLOCKS = 4 * N_SMS
#: rows per split are a multiple of one bf16 chunk of the kernel
SPLIT_QUANTUM = 64
#: the grid's split axis is CUDA's y dimension
MAX_SPLITS = 65535


def split_rows(s_max: int, n_kv_heads: int, batch: int) -> tuple[int, int]:
    """``(rows_per_split, n_split)`` of the grid ``(KV, n_split, B)``.

    From the cache's shape alone (never ``pos``, which stays on the
    device): the most rows per split, in multiples of 64, that still give
    :data:`TARGET_BLOCKS` blocks, but at least 64 rows and at most the
    whole cache."""
    q = SPLIT_QUANTUM
    rows = s_max * n_kv_heads * batch // TARGET_BLOCKS // q * q
    rows = max(rows, q, -(-s_max // MAX_SPLITS))
    rows = min(-(-rows // q) * q, -(-s_max // q) * q)
    return rows, -(-s_max // rows)


@functools.cache
def _launcher():
    fn = _build.load("decode_attention").decode_attention_launch
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 \
        + [ctypes.c_void_p, ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     pos: torch.Tensor):
    """q ``[B,H,Dh]``; k/v ``[B,S_max,KV,Dh]`` (the cache, read in place
    through its strides); pos ``[B]`` int32 in ``[0, S_max)`` → o
    ``[B,H,Dh]`` (contiguous, q's dtype).  ``pos`` stays on the device:
    the range is the caller's contract, as the cache's capacity is.  The
    cache is copied in 16-byte pieces: its data pointers must be 16-byte
    aligned and its (b, s, h) strides multiples of 8 elements."""
    check_inputs("decode_attention", q, (k, v), q_ndim=3)
    check_aligned("decode_attention", (k, v))
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
    rows, n_split = split_rows(S, KV, B)
    o = torch.empty((B, H, Dh), dtype=q.dtype, device=q.device)
    part_ml = torch.empty((B, H, n_split, 2), dtype=torch.float32,
                          device=q.device)
    part_acc = torch.empty((B, H, n_split, Dh), dtype=torch.float32,
                           device=q.device)
    strides = (ctypes.c_longlong * 10)(
        q.stride(0), q.stride(1), *k.stride()[:3], *v.stride()[:3],
        o.stride(0), o.stride(1))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _launcher()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                          pos.data_ptr(), o.data_ptr(), part_ml.data_ptr(),
                          part_acc.data_ptr(), DTYPES[q.dtype], B, S, H, KV,
                          Dh, rows, n_split, ctypes.addressof(strides),
                          1.0 / math.sqrt(Dh), stream)
    if err != 0:
        raise RuntimeError(f"decode_attention: kernel launch failed with "
                           f"CUDA error {err}")
    decode_attention.launches += 1
    return o


decode_attention.launches = 0
