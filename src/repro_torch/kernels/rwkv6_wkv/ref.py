"""Plain torch versions of the RWKV-6 WKV recurrence.

* :func:`wkv6_ref` is the literal per-step scan, the reference's oracle
  (``repro/kernels/rwkv6_wkv/ref.py``);
* :func:`wkv6_chunked_ref` is the chunked log-space form, the body of the
  reference's ``repro/models/rwkv6.py::wkv_chunked`` in its op order.  It
  computes what the CUDA kernels (``csrc/rwkv6_wkv.cu``) compute: the CPU
  runs it in the model, and the chip check holds the kernels against it;
* :func:`wkv6_chunk_parallel_ref` is the kernels' own algorithm: three
  passes (chunk states, state passing, outputs), the chunk cut into
  16-row tiles, and every product cut into bf16 pieces as their
  tensor-core products cut it, so that the CPU tests check the
  arithmetic the card runs.

Layouts are seq-major: r, k, v, lw ``[B, T, H, K]``; u ``[H, K]``; the
state ``[B, H, K, K]`` f32.  y comes back in r's dtype.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.pieces import (F32_PIECES, operand_pieces,
                                        split_einsum)


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
    contribution) → ``(y [B,T,H,K], state [B,H,K,K])``.  It computes in
    f32, or in f64 for f64 inputs (the gradient checks)."""
    B, T, H, K = r.shape
    acc = torch.promote_types(r.dtype, torch.float32)
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
    uf = u.to(acc)[None, :, None, :]
    t_idx = torch.arange(c, device=r.device)
    strict = t_idx[:, None] > t_idx[None, :]
    eye = torch.eye(c, device=r.device)
    ys = []
    for i in range(n):
        ll = lwc[i].to(acc)
        li = torch.cumsum(ll, dim=2)                    # inclusive
        lx = li - ll                                    # exclusive
        # pairwise decay exp(lx_t - li_s), s < t: exponent <= 0
        dec = torch.exp(lx[:, :, :, None, :] - li[:, :, None, :, :])
        rrf, kkf, vvf = (z[i].to(acc) for z in (rc, kc, vc))
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


#: rows of the tiles the kernels cut a chunk into
TILE = 16


def _diagonal_blocks(r, k, lx, li) -> torch.Tensor:
    """A (s < t) inside each diagonal 8 × 8 block, ``[..., c, c]``, as the
    output kernel builds it: ``e^{lx_t − li_s}`` as the product of
    ``e^{li_q − lx_q}`` over s < q < t (the exponents telescope, as lx_q
    is li at row q − 1, and each factor is ≤ 1), one multiply a step as s
    falls from t − 1; each pair's sum over k in f32."""
    c = r.shape[-2]
    pad = -c % (TILE // 2)
    rb, kb, eb = (F.pad(z, (0, 0, 0, pad)).unflatten(-2, (-1, TILE // 2))
                  for z in (r, k, torch.exp(li - lx)))   # [..., nb, 8, K]
    blocks = r.new_zeros((*rb.shape[:-1], TILE // 2))
    for t in range(1, TILE // 2):
        d = torch.ones_like(rb[..., t, :])
        for s in range(t - 1, -1, -1):
            if s < t - 1:
                d = d * eb[..., s + 1, :]
            blocks[..., t, s] = (rb[..., t, :] * kb[..., s, :] * d).sum(-1)
    a = r.new_zeros((*r.shape[:-1], c))
    for i, b0 in enumerate(range(0, c, TILE // 2)):
        b1 = min(b0 + TILE // 2, c)
        a[..., b0:b1, b0:b1] = blocks[..., i, :b1 - b0, :b1 - b0]
    return a


def _scores(r, k, u, lx, li, nf: int) -> torch.Tensor:
    """A of one chunk as the output kernel builds it, ``[..., c, c]`` from
    r, k, lx, li ``[..., c, K]`` (f32) and u ``[K]`` or broadcastable:

    * in each diagonal 8 × 8 block, ``Σ_k r_t k_s e^{lx_t − li_s}`` (s <
      t) by :func:`_diagonal_blocks` and ``Σ_k r_t u k_t`` (s = t), in f32;
    * in the lower-left 8 × 8 block of each diagonal 16 × 16 tile (rows 16
      i + 8 …, columns 16 i …) one product of ``r e^{lx − lx_16i+8}`` and
      ``k e^{lx_16i+8 − li}``;
    * below tile row i (rows 16 i …, columns s < 16 i) one product of ``r
      e^{lx − lx_16i}`` and ``k e^{lx_16i − li}``;

    each product's factors in ``nf`` bf16 pieces.  ``lx_j`` is li at row
    j − 1, which lies between the two rows' exponents as li falls, so
    that both are ≤ 0.  Zero above the diagonal."""
    c = r.shape[-2]
    a = _diagonal_blocks(r, k, lx, li) + torch.diag_embed((r * u * k).sum(-1))

    def below(lo, hi, s0):
        """A[lo:hi, s0:lo] as one product, the exponents split at lx_lo."""
        ref = lx[..., lo:lo + 1, :]
        ro = r[..., lo:hi, :] * torch.exp(lx[..., lo:hi, :] - ref)
        ko = k[..., s0:lo, :] * torch.exp(ref - li[..., s0:lo, :])
        a[..., lo:hi, s0:lo] = split_einsum("...tk,...sk->...ts", ro, nf,
                                            ko, nf)

    for t0 in range(0, c, TILE):
        t1 = min(t0 + TILE, c)
        if t0 + TILE // 2 < t1:
            below(t0 + TILE // 2, t1, t0)
        if t0:
            below(t0, t1, 0)
    return a


def wkv6_chunk_parallel_ref(r, k, v, lw, u, s0=None, chunk: int = 32):
    """The CUDA kernels' three passes in plain torch → ``(y [B,T,H,K],
    state [B,H,K,K])``, chunk ``min(chunk, T)``, a ragged tail padded as
    in :func:`wkv6_chunked_ref`:

    1. per chunk, for every chunk at once: li (cumsum of lw), lc = li of
       the last row, ``U = (k e^{lc − li})ᵀ v``, ``e^{lc}``;
    2. the state pass, in order over chunks: ``S_in = S``, ``S =
       diag(e^{lc}) S + U`` from ``s0`` (or zero);
    3. per chunk, for every chunk at once: lx = li of the row before (0
       in the first), A by :func:`_scores`, ``y = A v + (r e^{lx})
       S_in`` with ``r e^{lx}`` formed as ``(r e^{lx − lx_16i})
       e^{lx_16i}`` in tile row i.

    Every product is cut as the kernels' bf16 ``mma`` cuts it: an
    f32-valued factor (``k e^{lc − li}``, the factors of A, A itself,
    ``r e^{lx}``, ``S_in``) into three bf16 pieces whatever the
    activation type (the kernels' ``kFactorPieces``: with two, hi and lo,
    rwkv6-3b's bf16 logits drifted measurably); an input of the
    activation type as it is in bf16, in three pieces in f32
    (:mod:`repro_torch.kernels.pieces`)."""
    B, T, H, K = r.shape
    nx, nf = operand_pieces(r.dtype)[0], F32_PIECES
    c = min(chunk, T)
    T0 = T
    if T % c:
        pad = c - T % c
        r, k, v, lw = (F.pad(a, (0, 0, 0, 0, 0, pad)) for a in (r, k, v, lw))
        T = T + pad
    n = T // c

    def rs(x):
        return x.reshape(B, n, c, H, K).permute(0, 1, 3, 2, 4).float()

    rc, kc, vc, lwc = rs(r), rs(k), rs(v), rs(lw)       # [B,n,H,c,K]
    li = torch.cumsum(lwc, dim=3)
    lx = F.pad(li[..., :-1, :], (0, 0, 1, 0))
    # pass 1: U, all chunks at once
    lc = li[..., -1:, :]                                # [B,n,H,1,K]
    u_k = split_einsum("bnhsk,bnhsv->bnhkv", kc * torch.exp(lc - li), nf,
                       vc, nx)
    dec = torch.exp(lc[..., 0, :])[..., None]           # [B,n,H,K,1]
    # pass 2: the state, in order over chunks
    s = _zero_state(r) if s0 is None else s0.float()
    s_in = []
    for i in range(n):
        s_in.append(s)
        s = s * dec[:, i] + u_k[:, i]
    s_in = torch.stack(s_in, dim=1)                     # [B,n,H,K,K]
    # pass 3: y, all chunks at once
    a = _scores(rc, kc, u.float()[:, None, :], lx, li, nf)
    # r e^{lx} as the kernel forms it: r e^{lx - lx_16i} scaled by e^{lx_16i}
    top = lx[..., torch.arange(c, device=r.device) // TILE * TILE, :]
    carry = rc * torch.exp(lx - top) * torch.exp(top)
    y = split_einsum("bnhts,bnhsv->bnhtv", a, nf, vc, nx) \
        + split_einsum("bnhtk,bnhkv->bnhtv", carry, nf, s_in, nf)
    y = y.permute(0, 1, 3, 2, 4).reshape(B, T, H, K).to(r.dtype)
    return y[:, :T0], s
