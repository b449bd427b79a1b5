"""Plain torch versions of the Mamba-2 SSD scan.

* :func:`ssd_ref` is the literal per-step recurrence, the reference's
  oracle (``repro/kernels/mamba2_ssd/ref.py``);
* :func:`ssd_chunked_ref` is the chunked 1-semiseparable form, the body of
  the reference's ``repro/models/mamba2.py::ssd_chunked`` in its op order.
  It computes what the CUDA kernel (``csrc/mamba2_ssd.cu``) computes: the
  CPU runs it in the model, and the chip check holds the kernel against
  it.

Layouts are seq-major: x ``[B, T, H, P]``; dt_h ``[B, T, H]`` f32 (after
softplus); bmat, cmat ``[B, T, N]``; a ``[H]`` f32 (negative); the state
``[B, H, P, N]`` f32.  y comes back in x's dtype.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def _zero_state(x: torch.Tensor, n: int) -> torch.Tensor:
    B, _, H, P = x.shape
    return torch.zeros((B, H, P, n), dtype=torch.float32, device=x.device)


def ssd_ref(x, dt_h, bmat, cmat, a, h0=None):
    """Sequential f32 recurrence → ``(y [B,T,H,P], state [B,H,P,N])``."""
    a = a.float()
    h = _zero_state(x, bmat.shape[-1]) if h0 is None else h0
    ys = []
    for t in range(x.shape[1]):
        xt, dtt = x[:, t].float(), dt_h[:, t].float()
        decay = torch.exp(dtt * a[None, :])[:, :, None, None]
        upd = dtt[:, :, None, None] * xt[..., None] * \
            bmat[:, t].float()[:, None, None, :]
        h = h * decay + upd
        ys.append(torch.einsum("bhpn,bn->bhp", h, cmat[:, t].float()))
    return torch.stack(ys, dim=1).to(x.dtype), h


def ssd_chunked_ref(x, dt_h, bmat, cmat, a, h0=None, chunk: int = 128):
    """Chunked SSD scan with chunk ``min(chunk, T)``; a ragged tail is
    padded with ``dt = 0`` (no state contribution) and ``x = B = C = 0``
    → ``(y [B,T,H,P], state [B,H,P,N])``."""
    B, T, H, P = x.shape
    N = bmat.shape[-1]
    h = _zero_state(x, N) if h0 is None else h0
    c = min(chunk, T)
    T0 = T
    if T % c:
        pad = c - T % c
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt_h, bmat, cmat = (F.pad(z, (0, 0, 0, pad))
                            for z in (dt_h, bmat, cmat))
        T = T + pad
    n = T // c
    xc = x.reshape(B, n, c, H, P)
    dtc = dt_h.reshape(B, n, c, H)
    bc = bmat.reshape(B, n, c, N)
    cc = cmat.reshape(B, n, c, N)
    t_idx = torch.arange(c, device=x.device)
    mask = (t_idx[:, None] >= t_idx[None, :])[None, :, :, None]
    ys = []
    for i in range(n):
        xx, dd = xc[:, i].float(), dtc[:, i].float()
        bb, ccm = bc[:, i].float(), cc[:, i].float()
        la = torch.cumsum(dd * a[None, None, :], dim=1)      # [B,c,H] <= 0
        # intra-chunk scores M[t,s] = (C_t.B_s) exp(la_t - la_s) dt_s, s <= t
        cb = torch.einsum("btn,bsn->bts", ccm, bb)
        dec = torch.exp(la[:, :, None, :] - la[:, None, :, :])  # [B,t,s,H]
        m = torch.where(mask, cb[..., None] * dec * dd[:, None], 0.0)
        y = torch.einsum("btsh,bshp->bthp", m, xx)
        # carry-in: C_t . (h (.) e^{la_t})
        y = y + torch.einsum("btn,bhpn,bth->bthp", ccm, h, torch.exp(la))
        # h' = h e^{la_end} + sum_s e^{la_end - la_s} dt_s B_s (x) x_s
        la_end = la[:, -1:, :]
        w = torch.exp(la_end - la) * dd
        h = h * torch.exp(la_end[:, 0])[:, :, None, None] + torch.einsum(
            "bsh,bsn,bshp->bhpn", w, bb, xx)
        ys.append(y.to(x.dtype))
    y = torch.stack(ys, dim=1).reshape(B, T, H, P)
    return y[:, :T0], h
