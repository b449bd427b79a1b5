"""ctypes binding of the ``mamba2_ssd`` CUDA kernel.

The kernels (``src/repro_torch/csrc/mamba2_ssd.cu``: chunk states, state
passing, outputs) replace the Pallas TPU kernel
``repro/kernels/mamba2_ssd/kernel.py`` (``ssd_pallas``).  :func:`ssd`
checks its inputs, picks the head groups of the chunk-parallel passes from
the shapes alone (:func:`heads_per_block`), allocates the outputs and the
f32 scratch, launches the three passes on PyTorch's current stream and
raises if a launch was refused.  ``ssd.launches`` counts its calls
(three device launches each).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.kernel import (DTYPES,
                                                        UnsupportedShapeError)
from repro_torch.kernels.rwkv6_wkv.kernel import check_activations, check_f32

MAX_CHUNK = 128
MAX_HEAD_DIM = 64
MAX_STATE = 64
#: most heads one block of the output pass takes in turn
MAX_HEADS_PER_BLOCK = 8
#: blocks of the output pass resident on one SM in bf16 (by shared memory
#: and registers; one in f32)
OUT_BLOCKS_PER_SM = 2


def heads_per_block(n_heads: int, n_chunks: int, batch: int,
                    n_slots: int) -> int:
    """Heads each block of the output pass takes, one after the other.

    A block's time grows with its heads (plus about one head's worth of
    work shared by them: staging B and C, and C·Bᵀ); the call's time with
    the waves of ``n_slots`` resident blocks that the grid ``(n_chunks,
    ceil(H / g), B)`` needs.  The g that makes waves × (g + 1) least, the
    smaller on a tie."""
    def cost(g):
        blocks = n_chunks * batch * -(-n_heads // g)
        return -(-blocks // n_slots) * (g + 1)
    return min(range(1, min(MAX_HEADS_PER_BLOCK, n_heads) + 1), key=cost)


@functools.cache
def _launcher():
    fn = _build.load("mamba2_ssd").mamba2_ssd_launch
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 8 \
        + [ctypes.c_void_p] * 2
    fn.restype = ctypes.c_int
    return fn


def ssd(x, dt_h, bmat, cmat, a, h0=None, *, chunk: int = 128):
    """x ``[B,T,H,P]``, bmat/cmat ``[B,T,N]`` (f32 or bf16, any leading
    strides, last dim contiguous), dt_h ``[B,T,H]`` f32, a ``[H]`` f32, h0
    ``[B,H,P,N]`` f32 or ``None`` (zero) → ``(y [B,T,H,P] in x's dtype,
    state [B,H,P,N] f32)``; chunk ``min(chunk, T)``."""
    name = "mamba2_ssd"
    check_activations(name, (x, bmat, cmat))
    if x.dim() != 4 or bmat.dim() != 3:
        raise ValueError(f"{name}: x must be [B, T, H, P] and bmat [B, T, N],"
                         f" got {tuple(x.shape)} and {tuple(bmat.shape)}")
    B, T, H, P = x.shape
    N = bmat.shape[-1]
    dev = x.device
    for what, z in (("bmat", bmat), ("cmat", cmat)):
        if z.shape != (B, T, N):
            raise ValueError(f"{name}: {what} must be {(B, T, N)}, got "
                             f"{tuple(z.shape)}")
    check_f32(name, "dt_h", dt_h, dev, (B, T, H))
    check_f32(name, "a", a, dev, (H,))
    if h0 is not None:
        check_f32(name, "h0", h0, dev, (B, H, P, N))
    c = min(chunk, T)
    if not (1 <= c <= MAX_CHUNK and 1 <= P <= MAX_HEAD_DIM
            and 1 <= N <= MAX_STATE and T >= 1 and B <= 65535
            and H <= 65535):
        raise UnsupportedShapeError(
            f"{name}: needs 1 <= min(chunk, T) <= {MAX_CHUNK}, P <= "
            f"{MAX_HEAD_DIM}, N <= {MAX_STATE} and B, H <= 65535, got x "
            f"{tuple(x.shape)}, N={N}, chunk={chunk}")
    a = a.contiguous()
    h0 = None if h0 is None else h0.contiguous()
    n_chunks = -(-T // c)
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    out_heads = heads_per_block(
        H, n_chunks, B,
        n_sms * (OUT_BLOCKS_PER_SM if x.dtype == torch.bfloat16 else 1))
    y = torch.empty((B, T, H, P), dtype=x.dtype, device=dev)
    h_out = torch.empty((B, H, P, N), dtype=torch.float32, device=dev)
    # U_k from pass 1, overwritten with S_in,k by pass 2
    states = torch.empty((B, n_chunks, H, P, N), dtype=torch.float32,
                         device=dev)
    la_end = torch.empty((B, n_chunks, H), dtype=torch.float32, device=dev)
    strides = (ctypes.c_longlong * 13)(
        *x.stride()[:3], *dt_h.stride(), *bmat.stride()[:2],
        *cmat.stride()[:2], *y.stride()[:3])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = _launcher()(x.data_ptr(), dt_h.data_ptr(), bmat.data_ptr(),
                          cmat.data_ptr(), a.data_ptr(),
                          None if h0 is None else h0.data_ptr(),
                          y.data_ptr(), h_out.data_ptr(), states.data_ptr(),
                          la_end.data_ptr(), DTYPES[x.dtype], B, T, H, P, N,
                          c, out_heads, ctypes.addressof(strides), stream)
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error "
                           f"{err}")
    ssd.launches += 1
    return y, h_out


ssd.launches = 0
