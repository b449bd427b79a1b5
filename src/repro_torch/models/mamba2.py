"""Mamba-2 (SSD) block — the state-space backbone of zamba2.

Counterpart of ``repro/models/mamba2.py``.  Selective state space with a
scalar decay per head:

    h_t = exp(Δ_t·A_h) · h_{t-1} + Δ_t · B_t ⊗ x_t      h: [H, P, N]
    y_t = C_t · h_t + D_h · x_t

Prefill and the full forward (T > 1) run the chunked scan through
:func:`repro_torch.kernels.mamba2_ssd.ops.ssd`: the CUDA kernel on the
card, its plain chunked form on the CPU.  Decode (T == 1) is the plain
one-step recurrence with a rolling conv window, as in the reference.

Under a sharding context (:mod:`repro_torch.distribution.sharding`) the
projections are DTensor products.  ``in_proj``'s output columns ``[z |
xbc | dt]`` are split over ``ff`` at no head boundary (zamba2-2.7b's
10 448 columns in two halves cut inside ``xbc``), and the ``B``, ``C``
channels are shared by every head, so the block gathers the projection
whole over
``model`` and runs its slices and the causal conv on full columns (the
conv's carry stays whole, as the cache spec says).  The scan then runs in
a manual region on each rank's local heads, where the reference
constrains ``xin`` to heads: the rank's heads of ``xin``, ``Δ``, ``A``,
``D`` and the carried state (laid out as the cache spec says), with
``B`` and ``C`` whole.  The region closes with ``y`` split over ``d_in``
on head boundaries; the gated RMSNorm, whose mean runs over all of
``d_in``, is a DTensor reduction over that split (one all-reduce), and
``out_proj``'s rows split the same way.  Where the heads do not divide
the ``model`` axis every rank runs all of them.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.distribution.sharding import (from_local_as, head_region,
                                               shard, to_local_as, whole_dim)
from repro_torch.kernels.mamba2_ssd import ops as ssd_ops
from repro_torch.models.layers import dense_init, randn


def _dims(cfg):
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    n_heads = d_in // s.head_dim
    return s, d_in, n_heads


def init_mamba2(gen: torch.Generator, cfg) -> dict:
    s, d_in, H = _dims(cfg)
    D, N = cfg.d_model, s.d_state
    dt = cfg.p_dtype
    dev = gen.device
    conv_ch = d_in + 2 * N
    return {
        "in_proj": dense_init(gen, (D, 2 * d_in + 2 * N + H), dt),
        "conv_w": (randn(gen, (s.conv_width, conv_ch)) * 0.1).to(dt),
        "conv_b": torch.zeros((conv_ch,), dtype=dt, device=dev),
        "a_log": torch.zeros((H,), dtype=dt, device=dev),  # A = -exp(a_log)
        "d_skip": torch.ones((H,), dtype=dt, device=dev),
        "dt_bias": torch.zeros((H,), dtype=dt, device=dev),
        "norm_scale": torch.ones((d_in,), dtype=dt, device=dev),
        "out_proj": dense_init(gen, (d_in, D), dt),
    }


def init_mamba_state(cfg, batch: int, n_layers: int | None = None,
                     device=None) -> dict:
    """``{"conv": [L, B, W-1, d_in + 2N]`` in ``act_dtype``, ``"ssm":
    [L, B, H, P, N]`` f32}: zeros, the reference's layout."""
    s, d_in, H = _dims(cfg)
    L = n_layers if n_layers is not None else cfg.n_layers
    return {
        "conv": torch.zeros((L, batch, s.conv_width - 1, d_in + 2 * s.d_state),
                            dtype=cfg.act_dtype, device=device),
        "ssm": torch.zeros((L, batch, H, s.head_dim, s.d_state),
                           dtype=torch.float32, device=device),
    }


# ---------------------------------------------------------------------------
# SSD scan — chunked (prefill) and stepwise (decode)
# ---------------------------------------------------------------------------

def ssd_chunked(x, dt_h, bmat, cmat, a, h0, chunk: int = 128):
    """Chunked SSD scan.  x: ``[B,T,H,P]``; dt_h: ``[B,T,H]`` f32 (after
    softplus); bmat/cmat: ``[B,T,N]``; a: ``[H]`` f32 (negative); h0:
    ``[B,H,P,N]`` f32 → ``(y [B,T,H,P], h_out)``."""
    return ssd_ops.ssd(x, dt_h, bmat, cmat, a, h0, chunk=chunk)


def ssd_step(x, dt_h, bvec, cvec, a, h):
    """One-token SSD.  x: ``[B,H,P]``; dt_h: ``[B,H]``; b, c: ``[B,N]``;
    h: ``[B,H,P,N]``."""
    dd = dt_h.float()
    decay = torch.exp(dd * a[None, :])[:, :, None, None]
    upd = (dd[:, :, None, None] * x.float()[..., None]
           * bvec.float()[:, None, None, :])
    h_new = h * decay + upd
    y = torch.einsum("bhpn,bn->bhp", h_new, cvec.float())
    return y.to(x.dtype), h_new


def _ssd_heads(chunk, x, dt_h, bmat, cmat, a, d_skip, h):
    """The SSD scan and the ``D`` skip on the heads of ``x``
    (``[B,T,H,P]``), ``dt_h``, ``a``, ``d_skip`` and the state ``h`` →
    ``(y [B,T,H,P], h_out)``: all heads on one device, a rank's local heads
    under a sharding context."""
    if x.shape[1] == 1:
        y, h_out = ssd_step(x[:, 0], dt_h[:, 0], bmat[:, 0], cmat[:, 0], a, h)
        y = y[:, None]
    else:
        y, h_out = ssd_chunked(x, dt_h, bmat, cmat, a, h, chunk)
    return y + x * d_skip.to(x.dtype)[None, None, :, None], h_out


# ---------------------------------------------------------------------------
# Block forward
# ---------------------------------------------------------------------------

def _causal_conv(seq, w, b, conv_in):
    """seq: ``[B,T,C]``; w: ``[W,C]``; conv_in: ``[B,W-1,C]`` carry.
    Depthwise → ``(silu(conv), carry)``."""
    W = w.shape[0]
    T = seq.shape[1]
    full = torch.cat([conv_in, seq], dim=1)                # [B,T+W-1,C]
    out = sum(full[:, i:i + T] * w[i][None, None] for i in range(W))
    out = out + b[None, None]
    carry = full[:, -(W - 1):] if W > 1 else conv_in
    return F.silu(out), carry


def mamba2_block(cfg, p, x, state: dict):
    """x: ``[B,T,D]``; state: ``{conv [B,W-1,C], ssm [B,H,P,N]}`` →
    ``(out, new state)``."""
    s, d_in, H = _dims(cfg)
    N, P = s.d_state, s.head_dim
    B, T, D = x.shape
    dt = x.dtype
    proj = whole_dim(x @ p["in_proj"].to(dt), -1)
    z = proj[..., :d_in]
    xbc = proj[..., d_in:d_in + d_in + 2 * N]
    dt_raw = proj[..., -H:]
    xbc, conv_out = _causal_conv(xbc, p["conv_w"].to(dt), p["conv_b"].to(dt),
                                 state["conv"])
    xin = xbc[..., :d_in].reshape(B, T, H, P)
    bmat = xbc[..., d_in:d_in + N]
    cmat = xbc[..., d_in + N:]
    dt_h = F.softplus(dt_raw.float() + p["dt_bias"].float())
    a = -torch.exp(p["a_log"].float())
    # the reference constrains xin to ("batch", "seq", "heads"): the scan
    # and the skip on each rank's local heads
    b, h = head_region(H)
    act, st = (b, None, h, None), (b, h, None, None)
    y, ssm = _ssd_heads(
        s.chunk, to_local_as(xin, act), to_local_as(dt_h, (b, None, h)),
        *(to_local_as(m, (b, None, None), act) for m in (bmat, cmat)),
        to_local_as(a, (h,), act), to_local_as(p["d_skip"], (h,), act),
        to_local_as(state["ssm"], st))
    y = from_local_as(y.reshape(*y.shape[:2], -1), (b, None, h))
    ssm = from_local_as(ssm, st)
    # gated RMSNorm (Mamba-2): norm(y · silu(z))
    y = y * F.silu(z)
    yf = y.float()
    y = (yf * torch.rsqrt(torch.mean(yf * yf, -1, keepdim=True) + 1e-6)
         ).to(dt) * p["norm_scale"].to(dt)
    out = y @ p["out_proj"].to(dt)
    return shard(out, "batch", "seq", "embed"), {"conv": conv_out, "ssm": ssm}
