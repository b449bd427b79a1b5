"""Plain torch versions of the RWKV-6 WKV recurrence.

* :func:`wkv6_ref` is the literal per-step scan, the reference's oracle
  (``repro/kernels/rwkv6_wkv/ref.py``);
* :func:`wkv6_chunked_ref` is the chunked log-space form, the body of the
  reference's ``repro/models/rwkv6.py::wkv_chunked`` in its op order.  It
  computes what the CUDA kernel (``csrc/rwkv6_wkv.cu``) computes: the CPU
  runs it in the model, and the chip check holds the kernel against it.

Layouts are seq-major: r, k, v, lw ``[B, T, H, K]``; u ``[H, K]``; the
state ``[B, H, K, K]`` f32.  y comes back in r's dtype.
"""
from __future__ import annotations

import torch


def _zero_state(r: torch.Tensor) -> torch.Tensor:
    B, _, H, K = r.shape
    return torch.zeros((B, H, K, K), dtype=torch.float32, device=r.device)


def wkv6_ref(r, k, v, lw, u, s0=None):
    """Sequential f32 recurrence → ``(y [B,T,H,K], state [B,H,K,K])``."""
    s = _zero_state(r) if s0 is None else s0
    uf = u.float()[None, :, :, None]
    ys = []
    for t in range(r.shape[1]):
        rt, kt, vt, lt = (x[:, t].float() for x in (r, k, v, lw))
        kv = kt[..., :, None] * vt[..., None, :]
        ys.append(torch.einsum("bhk,bhkv->bhv", rt, s + uf * kv))
        s = s * torch.exp(lt)[..., None] + kv
    return torch.stack(ys, dim=1).to(r.dtype), s


def wkv6_chunked_ref(r, k, v, lw, u, s0=None, chunk: int = 32):
    """Chunked WKV scan with chunk ``min(chunk, T)``; a ragged tail is
    padded with ``lw = 0`` (decay 1) and ``r = k = v = 0`` (no
    contribution) → ``(y [B,T,H,K], state [B,H,K,K])``."""
    B, T, H, K = r.shape
    s = _zero_state(r) if s0 is None else s0
    c = min(chunk, T)
    T0 = T
    if T % c:
        pad = c - T % c
        r, k, v, lw = (torch.nn.functional.pad(a, (0, 0, 0, 0, 0, pad))
                       for a in (r, k, v, lw))
        T = T + pad
    n = T // c

    def rs(x):
        return x.reshape(B, n, c, H, K).permute(1, 0, 3, 2, 4)

    rc, kc, vc, lwc = rs(r), rs(k), rs(v), rs(lw)      # [n,B,H,c,K]
    uf = u.float()[None, :, None, :]
    t_idx = torch.arange(c, device=r.device)
    strict = t_idx[:, None] > t_idx[None, :]
    eye = torch.eye(c, device=r.device)
    ys = []
    for i in range(n):
        ll = lwc[i].float()
        li = torch.cumsum(ll, dim=2)                    # inclusive
        lx = li - ll                                    # exclusive
        # pairwise decay exp(lx_t - li_s), s < t: exponent <= 0
        dec = torch.exp(lx[:, :, :, None, :] - li[:, :, None, :, :])
        rrf, kkf, vvf = rc[i].float(), kc[i].float(), vc[i].float()
        a = (rrf[:, :, :, None, :] * kkf[:, :, None, :, :] * dec).sum(-1)
        a = torch.where(strict, a, 0.0)
        diag = (rrf * uf * kkf).sum(-1)
        a = a + eye * diag[..., None]
        y = torch.einsum("bhts,bhsk->bhtk", a, vvf)
        y = y + torch.einsum("bhtk,bhkv->bhtv", rrf * torch.exp(lx), s)
        lc = li[:, :, -1:, :]                           # [B,H,1,K]
        kd = kkf * torch.exp(lc - li)
        s = s * torch.exp(lc.squeeze(2))[..., None] + torch.einsum(
            "bhsk,bhsv->bhkv", kd, vvf)
        ys.append(y)
    y = torch.stack(ys).permute(1, 0, 3, 2, 4).reshape(B, T, H, K)
    return y.to(r.dtype)[:, :T0], s
