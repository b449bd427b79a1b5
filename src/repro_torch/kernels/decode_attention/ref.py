"""Plain torch version of one-token decode attention.

The same function as the CUDA kernel (``csrc/decode_attention.cu``) and as
the reference's ``decode_attention_ref`` (``repro/kernels/decode_attention``):
scores of each query row against the seq-major cache in f32, keys past
``pos`` masked with ``NEG_INF``, a softmax, and the output in q's dtype.
The CPU runs it for ``attn_impl="pallas"``; the chip check holds the kernel
against it.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def decode_attention_ref(q, k, v, pos):
    """q: ``[B,H,Dh]``; k, v: ``[B,S,KV,Dh]``; pos: ``[B]`` → ``[B,H,Dh]``
    (f32 math)."""
    B, H, Dh = q.shape
    S, KV = k.shape[1], k.shape[2]
    g = H // KV
    qf = q.float().reshape(B, KV, g, Dh)
    s = torch.einsum("bkgd,btkd->bkgt", qf, k.float()) / math.sqrt(Dh)
    t = torch.arange(S, device=q.device)
    mask = t[None, :] <= pos[:, None].to(t.dtype)
    s = torch.where(mask[:, None, None, :], s, NEG_INF)
    a = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgt,btkd->bkgd", a, v.float())
    return o.reshape(B, H, Dh).to(q.dtype)
