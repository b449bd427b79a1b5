"""Products as the port's tensor-core kernels compute them, in plain torch.

The scan kernels (``csrc/mamba2_ssd.cu``, ``csrc/rwkv6_wkv.cu``, with the
fragments of ``csrc/tile_mma.cuh``) run their products as bf16
``mma.sync`` with f32 accumulation: an input of the activation type
enters as it is in bf16, in :data:`F32_PIECES` bf16 pieces in f32, and an
f32-valued factor in bf16 pieces, hi and lo (three beside f32 inputs).
Their chunk-parallel plain forms use :func:`split_einsum` so that the CPU
tests check the arithmetic the card runs.
"""
from __future__ import annotations

import torch

#: bf16 pieces of an f32 input of the kernels' products (f32 activations
#: only): three carry its 24 bits
F32_PIECES = 3


def pieces(v: torch.Tensor, n: int) -> list[torch.Tensor]:
    """``v`` (f32) as ``n`` bf16-representable f32 pieces, largest first:
    hi = bf16(v), lo = bf16(v - hi), ... (their sum is v to about
    2^(-8n-1) relative)."""
    out, rest = [], v
    for _ in range(n):
        p = rest.to(torch.bfloat16).float()
        out.append(p)
        rest = rest - p
    return out


def split_einsum(eq: str, a, na: int, b, nb: int) -> torch.Tensor:
    """``einsum(eq, a, b)`` as bf16 tensor-core products with f32
    accumulation do it: a and b cut into ``na`` and ``nb`` bf16 pieces,
    and the piece products (i, j) with i + j < max(na, nb) summed, the
    smallest first."""
    pa, pb = pieces(a.float(), na), pieces(b.float(), nb)
    n = max(na, nb)
    terms = [(i, j) for i in range(na) for j in range(nb) if i + j < n]
    out = None
    for i, j in sorted(terms, key=lambda ij: -(ij[0] + ij[1])):
        t = torch.einsum(eq, pa[i], pb[j])
        out = t if out is None else out + t
    return out


def operand_pieces(dtype: torch.dtype) -> tuple[int, int]:
    """(pieces of an input of ``dtype``, pieces of an f32-valued factor
    beside it)."""
    nx = 1 if dtype == torch.bfloat16 else F32_PIECES
    return nx, max(2, nx)
