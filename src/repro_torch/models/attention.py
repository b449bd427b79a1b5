"""Attention: GQA/MQA (+qk-norm), MLA, prefill and KV-cache decode.

Counterpart of ``repro/models/attention.py``.  Causal self-attention is
selected by ``cfg.attn_impl``:

* ``pallas`` — the flash-attention kernel
  (:mod:`repro_torch.kernels.flash_attention`: the CUDA kernel on the
  card, its plain version on the CPU); one-token decode runs the
  decode-attention kernel (:mod:`repro_torch.kernels.decode_attention`).
* ``xla_chunked`` — q blocks of ``attn_chunk`` against the KV blocks up
  to the causal frontier, an online softmax in f32 (the reference's
  ``lax.scan`` over blocks with a ``lax.cond`` skip, here a Python loop
  that never visits a block above the diagonal); used when
  ``S > attn_chunk``.
* ``xla_unrolled`` — the same loop with blocks of
  ``max(attn_chunk, S // 8)`` (the reference's roofline impl).
* ``naive`` — the full ``[S, S]`` score matrix in plain torch; also what
  the two ``xla_*`` impls run when ``S <= attn_chunk``.

Decode under anything but ``pallas`` is plain torch in the reference's
op order (``attention.py:375-383``).

MLA (DeepSeek-V2, ``cfg.mla``): prefill decompresses the latent into
per-head k and v and runs the reference's own SDPA with distinct qk and
v head dims (``_mla_sdpa``: naive, or the chunked and unrolled loops;
the reference has no kernel for it, so ``pallas`` takes the naive
path); decode absorbs ``wk_b`` and ``wv_b`` and attends in the latent
space over a cache of ``kv_lora + qk_rope`` values a token.  Every
product mirrors the reference's einsums, with its casts in the same
places; no fused SDPA of torch stands in for them.

Not ported, because they act only under a sharding context, which the
port does not have: the head padding for uneven tensor parallelism
(``_gqa_tp_pad``: without a context the reference returns the heads
unpadded, ``attention.py:221-223``) and the shard-map flash-decodes
(``cache_seq_axes`` gives ``None`` without a context,
``attention.py:294-295``, which skips them).  Weights are stored flat
(``wq: [D, H*Dh]``) as in the reference.
"""
from __future__ import annotations

import math

import torch

from repro_torch import NotPortedError
from repro_torch.kernels.decode_attention import ops as da_ops
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.models.layers import apply_rope, dense_init, rmsnorm, zeros

NEG_INF = -1e30
PORTED_IMPLS = ("pallas", "naive", "xla_chunked", "xla_unrolled")


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


def _flash_blocks(q, k, v, qc: int, scale: float):
    """Causal attention over blocks of ``qc`` with an online softmax.

    q: ``[B,S,KV,G,D]``; k: ``[B,S,KV,D]``; v: ``[B,S,KV,Dv]`` →
    ``[B, (S // qc) * qc, KV, G, Dv]``.  Scores, the running max and sum
    and the accumulator are f32; ``p`` is cast to q's dtype before
    ``p·V``, as in the reference.  A KV block above the diagonal is never
    visited (the reference's ``lax.cond`` skip); the diagonal block is
    masked (below it the reference's mask is all true).
    """
    B, S, KV, G, _ = q.shape
    Dv = v.shape[-1]
    t = torch.arange(qc, device=q.device)
    diag = (t[:, None] >= t[None, :])[None, :, None, None, :]
    outs = []
    for qi in range(S // qc):
        qg = q[:, qi * qc:(qi + 1) * qc]
        acc = torch.zeros((B, qc, KV, G, Dv), dtype=torch.float32,
                          device=q.device)
        m = torch.full((B, qc, KV, G), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((B, qc, KV, G), dtype=torch.float32, device=q.device)
        for ki in range(qi + 1):
            k_blk = k[:, ki * qc:(ki + 1) * qc]
            v_blk = v[:, ki * qc:(ki + 1) * qc]
            s = torch.einsum("bqkgd,btkd->bqkgt", qg, k_blk).float() * scale
            if ki == qi:
                s = torch.where(diag, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bqkgt,btkd->bqkgd", p.to(q.dtype), v_blk).float()
            m = m_new
        outs.append((acc / l.clamp_min(1e-30)[..., None]).to(q.dtype))
    return torch.cat(outs, dim=1)


def _sdpa_chunked(q, k, v, chunk: int):
    """Flash-style causal attention in blocks of ``min(chunk, S)``
    (reference ``attention.py:100-160``).  q: ``[B,S,H,Dh]``; k, v:
    ``[B,S,KV,Dh]``."""
    B, S, H, Dh = q.shape
    KV = k.shape[2]
    qc = min(chunk, S)
    assert S % qc == 0, (S, qc)
    o = _flash_blocks(q.reshape(B, S, KV, H // KV, Dh), k, v, qc,
                      1.0 / math.sqrt(Dh))
    return o.reshape(B, S, H, Dh)


def _sdpa_unrolled(q, k, v, chunk: int):
    """The same blocks as :func:`_sdpa_chunked` (reference
    ``attention.py:163-200``, its roofline impl).  Like the reference it
    does not check ``S % chunk``: a ragged tail is left out of the
    output."""
    B, S, H, Dh = q.shape
    KV = k.shape[2]
    o = _flash_blocks(q.reshape(B, S, KV, H // KV, Dh), k, v,
                      min(chunk, S), 1.0 / math.sqrt(Dh))
    return o.reshape(B, -1, H, Dh)


def sdpa(cfg, q, k, v):
    """Dispatch causal self-attention by ``cfg.attn_impl`` (the
    reference's conditions, ``attention.py:249-257``)."""
    check_attn_impl(cfg)
    S = q.shape[1]
    if cfg.attn_impl == "pallas":
        return fa_ops.flash_attention(q, k, v)
    if cfg.attn_impl == "xla_unrolled" and S > cfg.attn_chunk:
        return _sdpa_unrolled(q, k, v, max(cfg.attn_chunk, S // 8))
    if cfg.attn_impl == "xla_chunked" and S > cfg.attn_chunk:
        return _sdpa_chunked(q, k, v, cfg.attn_chunk)
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


# ---------------------------------------------------------------------------
# MLA — Multi-head Latent Attention (DeepSeek-V2)
# ---------------------------------------------------------------------------

def init_mla(gen: torch.Generator, cfg) -> dict:
    m, D, H = cfg.mla, cfg.d_model, cfg.n_heads
    dt = cfg.p_dtype
    qk = m.qk_nope + m.qk_rope
    return {
        "wq_a": dense_init(gen, (D, m.q_lora), dt),             # q down
        "q_a_norm": zeros(gen, (m.q_lora,), dt),
        "wq_b": dense_init(gen, (m.q_lora, H * qk), dt),        # q up
        "wkv_a": dense_init(gen, (D, m.kv_lora + m.qk_rope), dt),
        "kv_a_norm": zeros(gen, (m.kv_lora,), dt),
        "wk_b": dense_init(gen, (m.kv_lora, H * m.qk_nope), dt),
        "wv_b": dense_init(gen, (m.kv_lora, H * m.v_dim), dt),
        "wo": dense_init(gen, (H * m.v_dim, D), dt),
    }


def _mla_q(cfg, p, x):
    """The low-rank query: ``[B, S, H, qk_nope + qk_rope]``."""
    m = cfg.mla
    dt = x.dtype
    cq = rmsnorm(x @ p["wq_a"].to(dt), p["q_a_norm"])
    q = cq @ p["wq_b"].to(dt)
    return q.reshape(*x.shape[:2], cfg.n_heads, m.qk_nope + m.qk_rope)


def _mla_qkv(cfg, p, x, pos):
    """Decompressed-path MLA projections (prefill).  Returns q, k
    ``[B,S,H,qk_nope+qk_rope]``, v ``[B,S,H,v_dim]`` and the cached
    ``(c_kv [B,S,kv_lora], k_rope [B,S,qk_rope])``, the key's rotary part
    already rotated."""
    m, H = cfg.mla, cfg.n_heads
    B, S, _ = x.shape
    dt = x.dtype
    q = _mla_q(cfg, p, x)
    q_nope, q_rope = q[..., :m.qk_nope], q[..., m.qk_nope:]
    kv = x @ p["wkv_a"].to(dt)
    c_kv = rmsnorm(kv[..., :m.kv_lora], p["kv_a_norm"])      # [B,S,kv_lora]
    k_rope = kv[..., m.kv_lora:][:, :, None, :]              # [B,S,1,rope]
    k_nope = (c_kv @ p["wk_b"].to(dt)).reshape(B, S, H, m.qk_nope)
    v = (c_kv @ p["wv_b"].to(dt)).reshape(B, S, H, m.v_dim)
    q_rope = apply_rope(q_rope, pos, cfg.rope_theta)
    k_rope = apply_rope(k_rope, pos, cfg.rope_theta)
    k_rope1 = k_rope[:, :, 0, :]                             # cached (roped)
    k_rope = k_rope.expand(B, S, H, m.qk_rope)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope], dim=-1)
    return q, k, v, (c_kv, k_rope1)


def mla_attention(cfg, p, x, pos):
    """Full-sequence MLA (prefill): decompress, then SDPA over the
    decompressed heads (a GQA group of 1)."""
    q, k, v, _ = _mla_qkv(cfg, p, x, pos)
    o = _mla_sdpa(cfg, q, k, v)
    B, S = x.shape[:2]
    return o.reshape(B, S, cfg.n_heads * cfg.mla.v_dim) @ p["wo"].to(x.dtype)


def _mla_sdpa(cfg, q, k, v):
    """Causal SDPA where the q/k head dim differs from v's (reference
    ``attention.py:468-482``): the chunked or unrolled loop when
    ``S > attn_chunk`` under those impls, the full score matrix
    otherwise (``pallas`` too: MLA has no kernel)."""
    B, S, H, qk = q.shape
    scale = 1.0 / math.sqrt(qk)
    if cfg.attn_impl == "xla_unrolled" and S > cfg.attn_chunk:
        return _sdpa_unrolled_vd(q, k, v, max(cfg.attn_chunk, S // 8),
                                 scale)
    if cfg.attn_impl == "xla_chunked" and S > cfg.attn_chunk:
        return _sdpa_chunked_vd(q, k, v, cfg.attn_chunk, scale)
    s = torch.einsum("bqhd,bthd->bhqt", q, k).float() * scale
    t = torch.arange(S, device=q.device)
    s = torch.where((t[:, None] >= t[None, :])[None, None], s, NEG_INF)
    a = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.einsum("bhqt,bthd->bqhd", a, v)


def _sdpa_chunked_vd(q, k, v, chunk: int, scale: float):
    """:func:`_sdpa_chunked` with distinct qk and v head dims (reference
    ``attention.py:485-535``, which asserts nothing: a ragged ``S`` fails
    its final reshape, as here)."""
    B, S, H, _ = q.shape
    o = _flash_blocks(q[:, :, :, None], k, v, min(chunk, S), scale)
    return o.reshape(B, S, H, v.shape[-1])


def _sdpa_unrolled_vd(q, k, v, chunk: int, scale: float):
    """:func:`_sdpa_unrolled` with distinct qk and v head dims (reference
    ``attention.py:537-568``)."""
    B, S, H, _ = q.shape
    o = _flash_blocks(q[:, :, :, None], k, v, min(chunk, S), scale)
    return o.reshape(B, -1, H, v.shape[-1])


def init_mla_cache(cfg, batch: int, max_len: int, device=None) -> dict:
    """The compressed latent and the shared rotary key, zeros in
    ``act_dtype``: ``{"c_kv": [L, B, max_len, kv_lora], "k_rope": [L, B,
    max_len, qk_rope]}`` (``kv_lora + qk_rope`` values a token instead of
    ``2·H·head_dim``)."""
    m, L = cfg.mla, cfg.n_layers
    return {"c_kv": torch.zeros((L, batch, max_len, m.kv_lora),
                                dtype=cfg.act_dtype, device=device),
            "k_rope": torch.zeros((L, batch, max_len, m.qk_rope),
                                  dtype=cfg.act_dtype, device=device)}


def mla_decode(cfg, p, x, c_kv_cache, k_rope_cache, pos):
    """One-token MLA decode with weight absorption (reference
    ``attention.py:584-624``, its unsharded branch).  x: ``[B,1,D]``;
    c_kv_cache ``[B,S_max,kv_lora]`` and k_rope_cache ``[B,S_max,qk_rope]``
    already hold this token at ``pos`` ``[B]``.  Scores in the latent
    space::

      q_lat = q_nope @ W_kb                    [B,H,kv_lora]
      s     = q_lat · c_kv + q_rope · k_rope   [B,H,S]
      o_lat = softmax(s) · c_kv                [B,H,kv_lora]
      o     = o_lat @ W_vb                     [B,H,v_dim]

    The two score terms are added in the activation dtype before the f32
    cast, as in the reference.
    """
    m, H = cfg.mla, cfg.n_heads
    B = x.shape[0]
    dt = x.dtype
    q = _mla_q(cfg, p, x).reshape(B, H, m.qk_nope + m.qk_rope)
    q_nope, q_rope = q[..., :m.qk_nope], q[..., m.qk_nope:]
    q_rope = apply_rope(q_rope[:, None], pos[:, None], cfg.rope_theta)[:, 0]
    wk_b = p["wk_b"].to(dt).reshape(m.kv_lora, H, m.qk_nope)
    q_lat = torch.einsum("bhn,rhn->bhr", q_nope, wk_b)        # absorb W_kb
    s = torch.einsum("bhr,btr->bht", q_lat, c_kv_cache)
    s = s + torch.einsum("bhn,btn->bht", q_rope, k_rope_cache)
    s = s.float() * (1.0 / math.sqrt(m.qk_nope + m.qk_rope))
    t = torch.arange(c_kv_cache.shape[1], device=x.device)
    s = torch.where((t[None, :] <= pos[:, None])[:, None, :], s, NEG_INF)
    a = torch.softmax(s, dim=-1).to(dt)
    o_lat = torch.einsum("bht,btr->bhr", a, c_kv_cache)
    wv_b = p["wv_b"].to(dt).reshape(m.kv_lora, H, m.v_dim)
    o = torch.einsum("bhr,rhv->bhv", o_lat, wv_b).reshape(B, H * m.v_dim)
    return (o @ p["wo"].to(dt))[:, None, :]


def mla_append_kv(cfg, p, x, c_kv_cache, k_rope_cache, pos):
    """Write this token's latent and rotated shared key into the caches
    at ``pos``, in place; the same tensors are returned."""
    m = cfg.mla
    B = x.shape[0]
    kv = x @ p["wkv_a"].to(x.dtype)
    c_kv = rmsnorm(kv[..., :m.kv_lora], p["kv_a_norm"])[:, 0]
    k_rope = apply_rope(kv[..., m.kv_lora:][:, :, None, :], pos[:, None],
                        cfg.rope_theta)[:, 0, 0]
    bidx = torch.arange(B, device=x.device)
    idx = pos.long()
    c_kv_cache[bidx, idx] = c_kv.to(c_kv_cache.dtype)
    k_rope_cache[bidx, idx] = k_rope.to(k_rope_cache.dtype)
    return c_kv_cache, k_rope_cache
