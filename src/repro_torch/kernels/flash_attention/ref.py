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


def flash_attention_tiled_ref(q, k, v, block=64):
    """The bf16 kernel's arithmetic in plain torch: key tiles of ``block``
    rows, an online softmax with f32 m, l and acc, and p rounded to q's
    dtype before ``p·V`` (l sums the unrounded p).  In f32 the rounding is
    the identity and this is :func:`flash_attention_ref`'s function; in
    bf16 it is the kernel's divergence from the Pallas kernel, which keeps
    p in f32."""
    B, S, H, Dh = q.shape
    KV = k.shape[2]
    qf = q.float().reshape(B, S, KV, H // KV, Dh)
    rows = torch.arange(S, device=q.device)
    m = torch.full((B, KV, H // KV, S), NEG_INF, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((B, KV, H // KV, S, Dh), device=q.device)
    for k0 in range(0, S, block):
        k1 = min(k0 + block, S)
        s = torch.einsum("bqkgd,btkd->bkgqt", qf, k[:, k0:k1].float()) \
            / math.sqrt(Dh)
        s = torch.where(rows[:, None] >= rows[None, k0:k1], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bkgqt,btkd->bkgqd", p.to(q.dtype).float(), v[:, k0:k1].float())
        m = m_new
    o = acc / l.clamp_min(1e-30)[..., None]
    return o.permute(0, 3, 1, 2, 4).reshape(B, S, H, Dh).to(q.dtype)
