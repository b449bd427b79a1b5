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


def decode_partials(q, k, v, pos, rows_per_split):
    """The split kernel's arithmetic in plain torch: for each split of
    ``rows_per_split`` cache rows, the f32 partials ``(m, l, acc)`` of its
    keys ``t <= pos`` (max score, sum of exp, unnormalised ``p·V``), each
    ``[n_split, B, H]`` (acc ``[n_split, B, H, Dh]``).  A split that starts
    past ``pos[b]`` is empty: ``m = NEG_INF``, ``l = 0``, ``acc = 0``."""
    B, H, Dh = q.shape
    S, KV = k.shape[1], k.shape[2]
    qf = q.float().reshape(B, KV, H // KV, Dh)
    t = torch.arange(S, device=q.device)
    ms, ls, accs = [], [], []
    for r0 in range(0, S, rows_per_split):
        r1 = min(r0 + rows_per_split, S)
        s = torch.einsum("bkgd,btkd->bkgt", qf, k[:, r0:r1].float()) \
            / math.sqrt(Dh)
        valid = (t[r0:r1][None, :] <= pos[:, None].to(t.dtype))[:, None, None]
        s = torch.where(valid, s, NEG_INF)
        m = s.amax(-1)
        p = torch.where(valid, torch.exp(s - m[..., None]), 0.0)
        empty = ~valid.any(-1)
        ms.append(torch.where(empty, NEG_INF, m).reshape(B, H))
        ls.append(p.sum(-1).reshape(B, H))
        accs.append(torch.einsum("bkgt,btkd->bkgd", p, v[:, r0:r1].float())
                    .reshape(B, H, Dh))
    return torch.stack(ms), torch.stack(ls), torch.stack(accs)


def combine_partials(m, l, acc, dtype):
    """The combine kernel's arithmetic: the splits' partials merged as one
    online softmax over all of them, ``acc / max(l, 1e-30)`` in ``dtype``.
    Empty partials (``l = 0``) weigh nothing."""
    w = torch.where(l > 0, torch.exp(m - m.amax(0)), 0.0)
    total = (l * w).sum(0)
    out = (acc * w[..., None]).sum(0)
    return (out / total.clamp_min(1e-30)[..., None]).to(dtype)


def decode_attention_split_ref(q, k, v, pos, rows_per_split):
    """Split-KV decode attention in plain torch: :func:`decode_partials`
    then :func:`combine_partials`; the same function as
    :func:`decode_attention_ref`."""
    return combine_partials(*decode_partials(q, k, v, pos, rows_per_split),
                            q.dtype)
