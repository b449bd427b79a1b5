"""RWKV-6 "Finch" block: data-dependent decay time-mix + channel-mix.

Counterpart of ``repro/models/rwkv6.py``.  The WKV recurrence per head
(K = V = head_size):

    S_t = diag(w_t) · S_{t-1} + k_tᵀ v_t
    y_t = r_t · (S_{t-1} + diag(u) · k_tᵀ v_t)

with the data-dependent decay ``w_t = exp(-exp(ŵ_t))``.  Prefill and the
full forward (T > 1) run the chunked scan through
:func:`repro_torch.kernels.rwkv6_wkv.ops.wkv6`: the CUDA kernel on the
card, its plain chunked form on the CPU.  Decode (T == 1) is the plain
one-step recurrence, as in the reference.

State per layer: the token-shift carries of the time-mix and channel-mix
and the ``[H, K, K]`` f32 WKV state.

Under a sharding context (:mod:`repro_torch.distribution.sharding`) the
projections are DTensor products and the reference's constraints stand
at its places.  Where the reference constrains ``r``, ``k``, ``v`` and
``lw`` to heads, the port opens a manual region on each rank's local
heads: the scan (the kernel sees plain local tensors), the per-head group
norm and the gate run there, on the rank's slice of ``u``, of the norm's
scale and bias and of the carried state (laid out as the cache spec
says), and the region closes before ``wo``, whose rows split the same
way.  Where the heads do not divide the ``model`` axis every rank runs
all of them.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.distribution.sharding import (from_local_as, head_region,
                                               shard, to_local_as)
from repro_torch.kernels.rwkv6_wkv import ops as wkv_ops
from repro_torch.models.layers import dense_init, randn, rmsnorm


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_rwkv_block(gen: torch.Generator, cfg) -> dict:
    r, D = cfg.rwkv, cfg.d_model
    F_ = int(r.ff_mult * D)
    dt = cfg.p_dtype
    dev = gen.device

    def full(shape, value):
        return torch.full(shape, value, dtype=dt, device=dev)

    def small(shape):
        return (randn(gen, shape) * 0.01).to(dt)

    tm = {
        "mu_x": full((D,), 0.5),
        "mu": full((5, D), 0.5),                          # r,k,v,w,g lerp
        "mix_w1": dense_init(gen, (D, 5 * r.mix_lora), dt),
        "mix_w2": small((5, r.mix_lora, D)),
        "wr": dense_init(gen, (D, D), dt),
        "wk": dense_init(gen, (D, D), dt),
        "wv": dense_init(gen, (D, D), dt),
        "wg": dense_init(gen, (D, D), dt),
        "wo": dense_init(gen, (D, D), dt),
        "decay_base": full((D,), -4.0),                   # ŵ bias
        "decay_w1": dense_init(gen, (D, r.decay_lora), dt),
        "decay_w2": small((r.decay_lora, D)),
        "bonus": full((D,), 0.0),                         # u, per channel
        "ln_scale": full((D,), 1.0),                      # per-head groupnorm
        "ln_bias": full((D,), 0.0),
    }
    cm = {
        "mu_k": full((D,), 0.5),
        "mu_r": full((D,), 0.5),
        "wk": dense_init(gen, (D, F_), dt),
        "wv": dense_init(gen, (F_, D), dt),
        "wr": dense_init(gen, (D, D), dt),
    }
    return {"tm": tm, "cm": cm, "ln1": full((D,), 0.0),
            "ln2": full((D,), 0.0)}


def init_rwkv_state(cfg, batch: int, n_layers: int | None = None,
                    device=None) -> dict:
    """``{"tm_shift", "cm_shift": [L, B, D]`` in ``act_dtype``, ``"wkv":
    [L, B, H, K, K]`` f32}: zeros, the reference's layout."""
    D = cfg.d_model
    K = cfg.rwkv.head_size
    H = D // K
    L = n_layers if n_layers is not None else cfg.n_layers
    return {
        "tm_shift": torch.zeros((L, batch, D), dtype=cfg.act_dtype,
                                device=device),
        "cm_shift": torch.zeros((L, batch, D), dtype=cfg.act_dtype,
                                device=device),
        "wkv": torch.zeros((L, batch, H, K, K), dtype=torch.float32,
                           device=device),
    }


# ---------------------------------------------------------------------------
# WKV — chunked (prefill) and stepwise (decode)
# ---------------------------------------------------------------------------

def wkv_chunked(r, k, v, lw, u, s0, chunk: int = 32):
    """Chunked WKV scan.  r, k, v: ``[B,T,H,K]``; lw: ``[B,T,H,K]`` f32
    log-decay (≤ 0); u: ``[H,K]`` f32; s0: ``[B,H,K,K]`` f32 carry-in →
    ``(y [B,T,H,K], s_out)``."""
    return wkv_ops.wkv6(r, k, v, lw, u, s0, chunk=chunk)


def wkv_step(r, k, v, lw, u, s):
    """Single-token WKV.  r, k, v, lw: ``[B,H,K]``; s: ``[B,H,K,V]`` f32."""
    rf, kf, vf = (x.float() for x in (r, k, v))
    kv = kf[..., :, None] * vf[..., None, :]               # [B,H,K,V]
    y = torch.einsum("bhk,bhkv->bhv",
                     rf, s + u[None].float()[..., None] * kv)
    s_new = s * torch.exp(lw.float())[..., None] + kv
    return y.to(r.dtype), s_new


# ---------------------------------------------------------------------------
# Block forward
# ---------------------------------------------------------------------------

def _shifted(x, shift_in):
    """``x`` moved one step later, ``shift_in`` in the first row."""
    return torch.cat([shift_in[:, None], x[:, :-1]], dim=1)


def _ddlerp(tm, x, x_prev):
    """Data-dependent token-shift interpolation (RWKV-6) → ``[5, B, T, D]``
    (the r, k, v, w, g inputs)."""
    B, T, D = x.shape
    dt = x.dtype
    xx = x_prev - x
    base = x + xx * tm["mu_x"].to(dt)
    lora = torch.tanh(base @ tm["mix_w1"].to(dt)).reshape(B, T, 5, -1)
    delta = torch.einsum("btfe,fed->fbtd", lora, tm["mix_w2"].to(dt))
    return x[None] + xx[None] * (tm["mu"].to(dt)[:, None, None] + delta)


def _wkv_heads(K, r, k, v, lw, g, u, scale, bias, s, chunk):
    """The WKV scan, its per-head group norm and the gate on the heads of
    ``r``, ``k``, ``v``, ``lw``, ``g`` (``[B,T,H·K]``), ``u``, ``scale``,
    ``bias`` (``[H·K]``) and the state ``s`` (``[B,H,K,K]`` f32) → ``(y
    [B,T,H·K], s_out)``: all heads on one device, a rank's local heads
    under a sharding context."""
    B, T, HK = r.shape
    dt = r.dtype
    hs = (B, T, HK // K, K)
    r_, k_, v_, lw_ = (a.reshape(hs) for a in (r, k, v, lw))
    u = u.float().reshape(HK // K, K)
    if T == 1:
        y, s_out = wkv_step(r_[:, 0], k_[:, 0], v_[:, 0], lw_[:, 0], u, s)
        y = y[:, None]
    else:
        y, s_out = wkv_chunked(r_, k_, v_, lw_, u, s, chunk)
    y = y.reshape(hs)
    mu = y.mean(-1, keepdim=True)
    var = ((y - mu) ** 2).mean(-1, keepdim=True)
    y = (y - mu) * torch.rsqrt(var + 64e-5)
    y = y.reshape(B, T, HK) * scale.to(dt) + bias.to(dt)
    return y.to(dt) * g, s_out


def time_mix(cfg, tm, x, shift_in, wkv_in, chunk: int = 32):
    """x: ``[B,T,D]`` → ``(out, shift_out, wkv_out)``."""
    D = x.shape[2]
    K = cfg.rwkv.head_size
    dt = x.dtype
    xr, xk, xv, xw, xg = _ddlerp(tm, x, _shifted(x, shift_in))
    r = xr @ tm["wr"].to(dt)
    k = xk @ tm["wk"].to(dt)
    v = xv @ tm["wv"].to(dt)
    g = F.silu(xg @ tm["wg"].to(dt))
    # the decay LoRA and ŵ are f32, as in the reference
    w_hat = tm["decay_base"].float() + (
        xw.float() @ tm["decay_w1"].float()) @ tm["decay_w2"].float()
    lw = -torch.exp(w_hat)                                 # log w ≤ 0

    # the reference constrains r, k, v, lw to ("batch", "seq", "heads"):
    # the scan, the group norm and the gate on each rank's local heads
    b, h = head_region(D // K)
    act, st = (b, None, h), (b, h, None, None)
    y, s_out = _wkv_heads(
        K, *(to_local_as(a, act) for a in (r, k, v, lw, g)),
        *(to_local_as(tm[n], (h,), act)
          for n in ("bonus", "ln_scale", "ln_bias")),
        to_local_as(wkv_in, st), chunk)
    out = from_local_as(y, act) @ tm["wo"].to(dt)
    return shard(out, "batch", "seq", "embed"), x[:, -1], \
        from_local_as(s_out, st)


def channel_mix(cfg, cm, x, shift_in):
    """x: ``[B,T,D]`` → ``(out, shift_out)``."""
    dt = x.dtype
    xx = _shifted(x, shift_in) - x
    xk = x + xx * cm["mu_k"].to(dt)
    xr = x + xx * cm["mu_r"].to(dt)
    k = torch.square(torch.relu(shard(xk @ cm["wk"].to(dt),
                                      "batch", "seq", "ff")))
    kv = k @ cm["wv"].to(dt)
    r = torch.sigmoid(xr @ cm["wr"].to(dt))
    return shard(r * kv, "batch", "seq", "embed"), x[:, -1]


def rwkv_block(cfg, p, x, state: dict, chunk: int = 32):
    """One RWKV-6 layer.  state: ``{tm_shift, cm_shift, wkv}`` of this
    layer → ``(x, new state)``."""
    # the normed inputs with their sequence whole (a no-op but under a
    # sequence-parallel residual): the token shift and the projections
    # read the whole sequence
    h = shard(rmsnorm(x, p["ln1"]), "batch", "seq", "embed")
    att, tm_shift, wkv = time_mix(cfg, p["tm"], h, state["tm_shift"],
                                  state["wkv"], chunk)
    # each output in the residual's layout before it is added: its
    # gradient then comes back laid out as the output was
    x = shard(x + shard(att, "batch", "act_seq", "embed"), "batch",
              "act_seq", "embed")
    h = shard(rmsnorm(x, p["ln2"]), "batch", "seq", "embed")
    ff, cm_shift = channel_mix(cfg, p["cm"], h, state["cm_shift"])
    x = shard(x + shard(ff, "batch", "act_seq", "embed"), "batch",
              "act_seq", "embed")
    return x, {"tm_shift": tm_shift, "cm_shift": cm_shift, "wkv": wkv}
