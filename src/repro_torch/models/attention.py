"""Attention: GQA/MQA (+qk-norm), prefill and KV-cache decode.

Counterpart of ``repro/models/attention.py`` for the dense families.
Causal self-attention is selected by ``cfg.attn_impl``:

* ``pallas`` — the flash-attention kernel
  (:mod:`repro_torch.kernels.flash_attention`: the CUDA kernel on the
  card, its plain version on the CPU); one-token decode runs the
  decode-attention kernel (:mod:`repro_torch.kernels.decode_attention`).
* ``naive`` — the full ``[S, S]`` score matrix in plain torch, and decode
  in the reference's op order (``attention.py:375-383``).
* ``xla_chunked`` / ``xla_unrolled`` raise :class:`NotPortedError`.

The reference's head padding for uneven tensor parallelism
(``_gqa_tp_pad``), its shard-map flash-decode and MLA wait for the
distribution and MoE slices.  Weights are stored flat (``wq: [D, H*Dh]``)
as in the reference.
"""
from __future__ import annotations

import math

import torch

from repro_torch import NotPortedError
from repro_torch.kernels.decode_attention import ops as da_ops
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.models.layers import apply_rope, dense_init, rmsnorm, zeros

NEG_INF = -1e30
PORTED_IMPLS = ("pallas", "naive")


def check_attn_impl(cfg) -> None:
    if cfg.attn_impl not in PORTED_IMPLS:
        raise NotPortedError(
            f"attn_impl={cfg.attn_impl!r} is not ported to repro_torch yet; "
            f"choose from {PORTED_IMPLS}")


# ---------------------------------------------------------------------------
# Parameter init
# ---------------------------------------------------------------------------

def init_attention(gen: torch.Generator, cfg) -> dict:
    D, Hq, Hkv, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dt = cfg.p_dtype
    p = {
        "wq": dense_init(gen, (D, Hq * Dh), dt),
        "wk": dense_init(gen, (D, Hkv * Dh), dt),
        "wv": dense_init(gen, (D, Hkv * Dh), dt),
        "wo": dense_init(gen, (Hq * Dh, D), dt),
    }
    if cfg.qk_norm:
        p["q_norm"] = zeros(gen, (Dh,), dt)
        p["k_norm"] = zeros(gen, (Dh,), dt)
    return p


def _qkv(cfg, p, x, pos):
    """Project and position-encode.  x: ``[B,S,D]`` → q ``[B,S,H,Dh]``,
    k/v ``[B,S,KV,Dh]``."""
    B, S, _ = x.shape
    Hq, Hkv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dt = x.dtype
    q = (x @ p["wq"].to(dt)).reshape(B, S, Hq, Dh)
    k = (x @ p["wk"].to(dt)).reshape(B, S, Hkv, Dh)
    v = (x @ p["wv"].to(dt)).reshape(B, S, Hkv, Dh)
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"])
        k = rmsnorm(k, p["k_norm"])
    if cfg.pos == "rope":
        q = apply_rope(q, pos, cfg.rope_theta)
        k = apply_rope(k, pos, cfg.rope_theta)
    return q, k, v


# ---------------------------------------------------------------------------
# Core causal attention
# ---------------------------------------------------------------------------

def _sdpa_naive(q, k, v):
    """Causal.  q: ``[B,S,H,Dh]``; k, v: ``[B,S,KV,Dh]``.  Full score
    matrix."""
    B, S, H, Dh = q.shape
    KV = k.shape[2]
    scale = 1.0 / math.sqrt(Dh)
    qg = q.reshape(B, S, KV, H // KV, Dh)
    s = torch.einsum("bqkgd,btkd->bkgqt", qg, k).float() * scale
    pos = torch.arange(S, device=q.device)
    s = torch.where(pos[:, None] >= pos[None, :], s, NEG_INF)
    a = torch.softmax(s, dim=-1).to(q.dtype)
    o = torch.einsum("bkgqt,btkd->bqkgd", a, v)
    return o.reshape(B, S, H, Dh)


def sdpa(cfg, q, k, v):
    """Dispatch causal self-attention by ``cfg.attn_impl``."""
    check_attn_impl(cfg)
    if cfg.attn_impl == "pallas":
        return fa_ops.flash_attention(q, k, v)
    return _sdpa_naive(q, k, v)


# ---------------------------------------------------------------------------
# KV-cache decode
# ---------------------------------------------------------------------------

def init_kv_cache(cfg, batch: int, max_len: int, device=None) -> dict:
    """``{"k", "v"}``, each ``[L, B, max_len, KV, Dh]`` zeros in
    ``act_dtype``: the reference's layout."""
    shp = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shp, dtype=cfg.act_dtype, device=device),
            "v": torch.zeros(shp, dtype=cfg.act_dtype, device=device)}


def decode_attention(cfg, p, x, k_cache, v_cache, pos):
    """One-token decode.  x: ``[B,1,D]``; k/v_cache: ``[B,S_max,KV,Dh]``
    (already holding this step's k, v at ``pos``); pos: ``[B]`` int32.

    Under ``attn_impl="pallas"`` the attention is the decode kernel, which
    reads the cache in place and keys ``t <= pos`` only; otherwise plain
    torch in the reference's op order (probabilities cast to the
    activation dtype before ``p·V``).
    """
    B = x.shape[0]
    Hq, KV, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dt = x.dtype
    q = (x @ p["wq"].to(dt)).reshape(B, Hq, Dh)
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"])
    if cfg.pos == "rope":
        q = apply_rope(q[:, None], pos[:, None], cfg.rope_theta)[:, 0]
    if cfg.attn_impl == "pallas":
        o = da_ops.decode_attention(q, k_cache, v_cache, pos)
    else:
        qg = q.reshape(B, KV, Hq // KV, Dh)
        s = torch.einsum("bkgd,btkd->bkgt", qg, k_cache).float()
        s = s * (1.0 / math.sqrt(Dh))
        t = torch.arange(k_cache.shape[1], device=x.device)
        mask = t[None, :] <= pos[:, None]                    # [B, S]
        s = torch.where(mask[:, None, None, :], s, NEG_INF)
        a = torch.softmax(s, dim=-1).to(dt)
        o = torch.einsum("bkgt,btkd->bkgd", a, v_cache)
    out = o.reshape(B, Hq * Dh) @ p["wo"].to(dt)
    return out[:, None, :]                                   # [B, 1, D]


def append_kv(cfg, p, x, k_cache, v_cache, pos):
    """Project this token's k, v and write them into the cache at ``pos``.

    The write is in place into the preallocated cache (the reference
    returns updated copies); the same tensors are returned.
    """
    B = x.shape[0]
    KV, Dh = cfg.n_kv_heads, cfg.head_dim
    dt = x.dtype
    k = (x @ p["wk"].to(dt)).reshape(B, 1, KV, Dh)
    v = (x @ p["wv"].to(dt)).reshape(B, 1, KV, Dh)
    if cfg.qk_norm:
        k = rmsnorm(k, p["k_norm"])
    if cfg.pos == "rope":
        k = apply_rope(k, pos[:, None], cfg.rope_theta)
    bidx = torch.arange(B, device=x.device)
    idx = pos.long()
    k_cache[bidx, idx] = k[:, 0].to(k_cache.dtype)
    v_cache[bidx, idx] = v[:, 0].to(v_cache.dtype)
    return k_cache, v_cache
