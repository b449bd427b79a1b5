"""Plain torch version of causal GQA flash attention.

The same function as the CUDA kernel (``csrc/flash_attention.cu``) and as
the reference's ``flash_attention_ref`` (``repro/kernels/flash_attention``):
the full score matrix in f32, the causal mask with ``NEG_INF``, a softmax,
and the output in q's dtype.  The CPU runs it for ``attn_impl="pallas"``;
the chip check holds the kernel against it.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def flash_attention_ref(q, k, v):
    """q: ``[B,S,H,Dh]``; k, v: ``[B,S,KV,Dh]`` → ``[B,S,H,Dh]`` (f32 math)."""
    B, S, H, Dh = q.shape
    KV = k.shape[2]
    g = H // KV
    qf = q.float().reshape(B, S, KV, g, Dh)
    s = torch.einsum("bqkgd,btkd->bkgqt", qf, k.float()) / math.sqrt(Dh)
    pos = torch.arange(S, device=q.device)
    mask = pos[:, None] >= pos[None, :]
    s = torch.where(mask, s, NEG_INF)
    a = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqt,btkd->bqkgd", a, v.float())
    return o.reshape(B, S, H, Dh).to(q.dtype)
