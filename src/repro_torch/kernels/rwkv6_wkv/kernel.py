"""ctypes binding of the ``rwkv6_wkv`` CUDA kernel.

The kernels (``src/repro_torch/csrc/rwkv6_wkv.cu``: chunk states, state
passing, outputs) replace the Pallas TPU kernel
``repro/kernels/rwkv6_wkv/kernel.py`` (``wkv6_hm``).  :func:`wkv6`
checks its inputs, allocates the outputs and the f32 scratch, launches
the three passes on PyTorch's current stream and raises if a launch was
refused.  The launch sizes come from the shapes alone: the two
chunk-parallel passes take one block per (chunk, head, batch row), the
state pass one per 16 × 16 tile of each (head, batch row)'s state; so a
call can be captured in a CUDA graph.  ``wkv6.launches`` counts its calls
(three device launches each).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.kernel import (DTYPES,
                                                        UnsupportedShapeError)

HEAD_SIZE = 64
MAX_CHUNK = 64


@functools.cache
def _launcher():
    fn = _build.load("rwkv6_wkv").rwkv6_wkv_launch
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6 \
        + [ctypes.c_void_p] * 2
    fn.restype = ctypes.c_int
    return fn


def check_f32(name: str, what: str, x: torch.Tensor, device, shape) -> None:
    """A float32 input of ``shape`` on ``device``."""
    if not x.is_cuda or x.device != device:
        raise ValueError(f"{name}: {what} must be a CUDA tensor on {device}, "
                         f"got one on {x.device}")
    if x.dtype != torch.float32:
        raise ValueError(f"{name}: {what} must be float32, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name}: {what} must be {tuple(shape)}, got "
                         f"{tuple(x.shape)}")


def check_activations(name: str, xs) -> None:
    """Activations of one supported dtype on one CUDA device, with the last
    dimension contiguous."""
    x0 = xs[0]
    for x in xs:
        if not x.is_cuda or x.device != x0.device:
            raise ValueError(f"{name}: every input must be a CUDA tensor on "
                             f"{x0.device}, got one on {x.device}")
        if x.dtype != x0.dtype:
            raise ValueError(f"{name}: activations must share one dtype, got "
                             f"{x0.dtype} and {x.dtype}")
        if x.stride(-1) != 1:
            raise ValueError(f"{name}: the last dim must be contiguous, got "
                             f"strides {x.stride()}")
    if x0.dtype not in DTYPES:
        raise UnsupportedShapeError(f"{name}: dtype {x0.dtype} is not built; "
                                    f"choose from {tuple(DTYPES)}")


def wkv6(r, k, v, lw, u, s0=None, *, chunk: int = 32):
    """r, k, v ``[B,T,H,K]`` (f32 or bf16, any (b, t, h) strides, last dim
    contiguous), lw ``[B,T,H,K]`` f32, u ``[H,K]`` f32, s0 ``[B,H,K,K]`` f32
    or ``None`` (zero) → ``(y [B,T,H,K] in r's dtype, state [B,H,K,K]
    f32)``; chunk ``min(chunk, T)``."""
    name = "rwkv6_wkv"
    check_activations(name, (r, k, v))
    if r.dim() != 4:
        raise ValueError(f"{name}: r must be [B, T, H, K], got "
                         f"{tuple(r.shape)}")
    B, T, H, K = r.shape
    dev = r.device
    for what, x in (("k", k), ("v", v)):
        if x.shape != r.shape:
            raise ValueError(f"{name}: {what} must be {tuple(r.shape)}, got "
                             f"{tuple(x.shape)}")
    check_f32(name, "lw", lw, dev, r.shape)
    check_f32(name, "u", u, dev, (H, K))
    if s0 is not None:
        check_f32(name, "s0", s0, dev, (B, H, K, K))
    if lw.stride(-1) != 1:
        raise ValueError(f"{name}: lw's last dim must be contiguous")
    c = min(chunk, T)
    if K != HEAD_SIZE or not 1 <= c <= MAX_CHUNK or T < 1 or B > 65535 \
            or H > 65535:
        raise UnsupportedShapeError(
            f"{name}: needs K={HEAD_SIZE}, 1 <= min(chunk, T) <= {MAX_CHUNK} "
            f"and B, H <= 65535, got {tuple(r.shape)}, chunk={chunk}")
    u = u.contiguous()
    s0 = None if s0 is None else s0.contiguous()
    y = torch.empty((B, T, H, K), dtype=r.dtype, device=dev)
    s_out = torch.empty((B, H, K, K), dtype=torch.float32, device=dev)
    # from PyTorch's caching allocator, so that a captured call reuses them:
    # U_k^T (pass 1, [v][k] per head), overwritten with S_in,k^T by pass 2,
    # and e^{lc} of each chunk
    n_chunks = -(-T // c)
    states = torch.empty((B, n_chunks, H, K, K), dtype=torch.float32,
                         device=dev)
    decay = torch.empty((B, n_chunks, H, K), dtype=torch.float32, device=dev)
    strides = (ctypes.c_longlong * 15)(
        *(x.stride(i) for x in (r, k, v, lw, y) for i in range(3)))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = _launcher()(r.data_ptr(), k.data_ptr(), v.data_ptr(),
                          lw.data_ptr(), u.data_ptr(),
                          None if s0 is None else s0.data_ptr(),
                          y.data_ptr(), s_out.data_ptr(), states.data_ptr(),
                          decay.data_ptr(), DTYPES[r.dtype], B, T, H, K, c,
                          ctypes.addressof(strides), stream)
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error "
                           f"{err}")
    wkv6.launches += 1
    return y, s_out


wkv6.launches = 0
