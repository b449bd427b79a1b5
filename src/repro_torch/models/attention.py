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

Under a sharding context (:mod:`repro_torch.distribution.sharding`) the
projections are DTensor products with the reference's constraints at its
places (heads over ``model``, batch over the data axes), and the
attention itself is a manual region on each rank's local heads
(:func:`sdpa`, :func:`decode_attention`): the kernels, or the plain
versions on the CPU, see local tensors only.  The reference's head
padding for uneven tensor parallelism (:func:`_gqa_tp_pad`) pads the
query groups so the heads split evenly; a decode cache whose sequence
dim is sharded (:func:`cache_seq_axes`) is read by the seq-sharded
flash-decodes (:func:`_flash_decode_sharded`,
:func:`_mla_flash_decode_sharded`): each rank scores its slice of the
cache at its global offset and an all-reduce (MAX of ``m``, SUM of ``l``
and ``o``) over the shard group merges them, the reference's ``pmax``
and ``psum``.  Cache writes under a context land on the shards that hold
the rows (:func:`write_rows`, :func:`write_prefix`).  Weights are stored
flat (``wq: [D, H*Dh]``) as in the reference.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch import NotPortedError
from repro_torch.distribution.sharding import (all_reduce, axis_index,
                                               axis_size, current_ctx,
                                               from_local_as, is_dtensor,
                                               n_shards, phys, pspec, shard,
                                               spec_of, to_local_as,
                                               tp_size, whole_dim)
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


def split_heads(x, *shape):
    """``x`` ``[..., H·Dh]`` → ``shape`` ``[..., H, Dh]``.  A sharded flat
    dim whose shards do not hold whole heads (``H`` not a multiple of its
    pieces: the reference's uneven heads, which GSPMD pads) is gathered
    first."""
    if shape[-2] % n_shards(x, -1):
        x = whole_dim(x, -1)
    return x.reshape(*shape)


def merge_heads(o, *shape):
    """``o`` ``[..., H, Dh]`` → ``shape`` ``[..., H·Dh]``.  Where ``H``
    does not split evenly over the model axis (the heads kept whole, or
    split unevenly), the heads are gathered and merged on each rank's own
    tensor: the gradient then comes back whole over the merged dim, which
    DTensor could not unflatten into heads if it came back split over
    model without whole heads in each piece."""
    if is_dtensor(o) and o.shape[-2] % tp_size():
        spec = (*spec_of(o)[:-2], None, None)
        ol = to_local_as(o, spec)
        return from_local_as(ol.reshape(*ol.shape[:-2], -1), spec[:-1])
    return o.reshape(*shape)


def _qkv(cfg, p, x, pos):
    """Project and position-encode.  x: ``[B,S,D]`` → q ``[B,S,H,Dh]``,
    k/v ``[B,S,KV,Dh]``."""
    B, S, _ = x.shape
    Hq, Hkv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dt = x.dtype
    q = split_heads(x @ p["wq"].to(dt), B, S, Hq, Dh)
    k = split_heads(x @ p["wk"].to(dt), B, S, Hkv, Dh)
    v = split_heads(x @ p["wv"].to(dt), B, S, Hkv, Dh)
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"])
        k = rmsnorm(k, p["k_norm"])
    if cfg.pos == "rope":
        q = apply_rope(q, pos, cfg.rope_theta)
        k = apply_rope(k, pos, cfg.rope_theta)
    q = shard(q, "batch", "seq", "heads", None)
    k = shard(k, "batch", "seq", "kv_heads", None)
    v = shard(v, "batch", "seq", "kv_heads", None)
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


def _gqa_tp_pad(cfg, q, k, v):
    """Pad query heads / replicate KV heads so attention shards evenly
    (reference ``attention.py:203-239``).

    When ``H % TP != 0`` (e.g. qwen3's 40 heads on a 16-way model axis)
    each of the KV heads is replicated ``rep = TP/KV`` times and its query
    group padded to ``rep·⌈G/rep⌉``: the group-to-KV mapping is kept, and
    the padded heads are sliced off after SDPA.  The reshuffle runs on
    each rank's batch shard with the heads whole; the padded heads are
    then split over ``model``.

    Returns (q', k', v', unpad) where unpad maps [B,S,H',Dh]→[B,S,H,Dh].
    """
    tp = axis_size("heads")
    H, KV = cfg.n_heads, cfg.n_kv_heads
    if (not cfg.gqa_pad or current_ctx() is None or tp <= 1
            or not cfg.shard_heads or H % tp == 0 or tp % KV != 0):
        return q, k, v, None
    rep = tp // KV
    G = H // KV
    Gp = -(-G // rep)                      # ceil
    S, Dh = q.shape[1], q.shape[3]
    whole = (pspec("batch")[0], None, None, None)
    ql, kl, vl = (to_local_as(t, whole) for t in (q, k, v))
    Bl = ql.shape[0]
    qg = F.pad(ql.reshape(Bl, S, KV, G, Dh), (0, 0, 0, rep * Gp - G))
    qp = qg.reshape(Bl, S, KV * rep * Gp, Dh)
    kp = kl.repeat_interleave(rep, dim=2)
    vp = vl.repeat_interleave(rep, dim=2)
    qp, kp, vp = (shard(from_local_as(t, whole), "batch", "seq", "heads",
                        None) for t in (qp, kp, vp))

    def unpad(o):
        ol = to_local_as(o, whole).reshape(Bl, S, KV, rep * Gp, Dh)
        ol = ol[:, :, :, :G].reshape(Bl, S, H, Dh)
        return shard(from_local_as(ol, whole), "batch", "seq", "heads", None)

    return qp, kp, vp, unpad


def _local_heads(H: int, KV: int) -> tuple[bool, bool]:
    """Whether a manual region splits the query heads, and the kv heads
    with them, over the ``heads`` axes: the queries when ``H`` divides
    evenly, the kv heads when ``KV`` does too (each rank's query groups
    then read only its own kv heads)."""
    tp = axis_size("heads")
    q_sh = tp > 1 and H % tp == 0
    return q_sh, (q_sh and phys("kv_heads") == phys("heads")
                  and KV % tp == 0)


def _sdpa_sharded(cfg, q, k, v):
    """Causal attention on each rank's local heads (a manual region over
    the batch and ``heads`` axes).  Where the query heads split and the kv
    heads do not, each local query head takes its kv head (a group of
    one)."""
    q, k, v, unpad = _gqa_tp_pad(cfg, q, k, v)
    H, KV = q.shape[2], k.shape[2]
    b, hp = pspec("batch")[0], pspec("heads")[0]
    q_sh, kv_sh = _local_heads(H, KV)
    q_spec = (b, None, hp if q_sh else None, None)
    kv_spec = (b, None, hp if kv_sh else None, None)
    ql = to_local_as(q, q_spec)
    # where the kv heads stay whole, each rank's query heads take a part of
    # their gradient, summed over model on the way back
    kl, vl = to_local_as(k, kv_spec, q_spec), to_local_as(v, kv_spec, q_spec)
    if q_sh and not kv_sh:
        n = ql.shape[2]
        lo = axis_index(phys("heads")) * n
        idx = torch.arange(lo, lo + n, device=ql.device) // (H // KV)
        kl, vl = kl[:, :, idx], vl[:, :, idx]
    o = from_local_as(_sdpa_local(cfg, ql, kl, vl), q_spec)
    return unpad(o) if unpad is not None else o


def sdpa(cfg, q, k, v):
    """Dispatch causal self-attention by ``cfg.attn_impl`` (the
    reference's conditions, ``attention.py:249-257``); under a sharding
    context, on each rank's local heads."""
    check_attn_impl(cfg)
    if current_ctx() is not None:
        return _sdpa_sharded(cfg, q, k, v)
    return _sdpa_local(cfg, q, k, v)


def _sdpa_local(cfg, q, k, v):
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


def cache_seq_axes(cfg):
    """Physical mesh axes the decode-cache sequence dim is sharded over
    (mirrors the cache-spec logic in transformer.py; reference
    ``attention.py:289-301``)."""
    if current_ctx() is None:
        return None
    kv_ok = (cfg.shard_heads
             and cfg.n_kv_heads % max(axis_size("kv_heads"), 1) == 0
             and axis_size("kv_heads") > 1)
    if cfg.mla is not None or not kv_ok:
        return phys("seq_kv", "seq_kv_tp")
    return phys("seq_kv")


def _axes_spec(axes):
    return axes if len(axes) > 1 else axes[0]


def _flash_decode_sharded(qg, k_cache, v_cache, pos, scale, axes):
    """Partial-softmax flash-decode over a seq-sharded cache (reference
    ``attention.py:304-345``).

    qg: ``[B,KV,G,Dh]`` (whole over ``axes``); k/v_cache: ``[B,S,KV,Dh]``
    with S sharded over ``axes``; pos: ``[B]``.  Each shard scores only
    its local cache slice, at its global offset, in f32; the combine is
    an all-reduce of ``m`` (MAX) and of ``l`` and ``o`` (SUM) over the
    shard group instead of a gathered ``[B,H,S]`` score array.
    """
    b = pspec("batch")[0]
    ql = to_local_as(qg, (b, None, None, None))
    seq = (b, _axes_spec(axes), None, None)
    kc, vc = to_local_as(k_cache, seq), to_local_as(v_cache, seq)
    pl = to_local_as(pos, (b,))
    S_l = kc.shape[1]
    t = axis_index(axes) * S_l + torch.arange(S_l, device=kc.device)
    s = torch.einsum("bkgd,btkd->bkgt", ql, kc).float() * scale
    s = torch.where((t[None, :] <= pl[:, None])[:, None, None, :], s, NEG_INF)
    m = all_reduce(s.amax(dim=-1), "max", axes)
    p = torch.exp(s - m[..., None])
    l = all_reduce(p.sum(dim=-1), "sum", axes)
    o = torch.einsum("bkgt,btkd->bkgd", p.to(ql.dtype), vc)
    o = all_reduce(o.float(), "sum", axes)
    o = (o / l.clamp_min(1e-30)[..., None]).to(ql.dtype)
    return from_local_as(o, (b, None, None, None))


def _decode_local(cfg, q, k_cache, v_cache, pos):
    """Decode attention of q ``[B,H,Dh]`` over a cache ``[B,S,KV,Dh]``:
    the kernel under ``pallas``, else plain torch in the reference's op
    order (probabilities cast to q's dtype before ``p·V``)."""
    if cfg.attn_impl == "pallas":
        return da_ops.decode_attention(q, k_cache, v_cache, pos)
    B, H, Dh = q.shape
    KV = k_cache.shape[2]
    qg = q.reshape(B, KV, H // KV, Dh)
    s = torch.einsum("bkgd,btkd->bkgt", qg, k_cache).float()
    s = s * (1.0 / math.sqrt(Dh))
    t = torch.arange(k_cache.shape[1], device=q.device)
    mask = t[None, :] <= pos[:, None]                        # [B, S]
    s = torch.where(mask[:, None, None, :], s, NEG_INF)
    a = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.einsum("bkgt,btkd->bkgd", a, v_cache).reshape(B, H, Dh)


def _decode_sharded(cfg, q, k_cache, v_cache, pos):
    """Decode attention under a sharding context: the seq-sharded
    flash-decode where the cache's sequence dim is split
    (:func:`cache_seq_axes`), else a manual region on each rank's local
    kv heads and their query groups (all heads where they do not
    split)."""
    B, H, Dh = q.shape
    KV = cfg.n_kv_heads
    axes = cache_seq_axes(cfg) if cfg.flash_decode else None
    if axes:
        qg = whole_dim(q, 1).reshape(B, KV, H // KV, Dh)
        o = _flash_decode_sharded(qg, k_cache, v_cache, pos,
                                  1.0 / math.sqrt(Dh), axes)
        return o.reshape(B, H, Dh)
    b, hp = pspec("batch")[0], pspec("heads")[0]
    kv_sh = _local_heads(H, KV)[1]
    q_spec = (b, hp if kv_sh else None, None)
    c_spec = (b, None, hp if kv_sh else None, None)
    o = _decode_local(cfg, to_local_as(q, q_spec),
                      to_local_as(k_cache, c_spec),
                      to_local_as(v_cache, c_spec), to_local_as(pos, (b,)))
    return from_local_as(o, q_spec)


def decode_attention(cfg, p, x, k_cache, v_cache, pos):
    """One-token decode.  x: ``[B,1,D]``; k/v_cache: ``[B,S_max,KV,Dh]``
    (already holding this step's k, v at ``pos``); pos: ``[B]`` int32.

    Under ``attn_impl="pallas"`` the attention is the decode kernel, which
    reads the cache in place and keys ``t <= pos`` only; otherwise plain
    torch in the reference's op order.  Under a sharding context see
    :func:`_decode_sharded`.
    """
    B = x.shape[0]
    Hq, Dh = cfg.n_heads, cfg.head_dim
    dt = x.dtype
    q = split_heads(x @ p["wq"].to(dt), B, Hq, Dh)
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"])
    if cfg.pos == "rope":
        q = apply_rope(q[:, None], pos[:, None], cfg.rope_theta)[:, 0]
    if current_ctx() is not None:
        o = _decode_sharded(cfg, q, k_cache, v_cache, pos)
    else:
        o = _decode_local(cfg, q, k_cache, v_cache, pos)
    out = merge_heads(o, B, Hq * Dh) @ p["wo"].to(dt)
    return out[:, None, :]                                   # [B, 1, D]


def write_rows(cache, new, pos) -> None:
    """``cache[b, pos[b]] = new[b]`` in place (cache ``[B, S, ...]``, new
    ``[B, ...]``).  A sharded cache is written on the shards that hold
    row ``pos[b]``, from ``new`` laid out as the cache is."""
    if not is_dtensor(cache):
        bidx = torch.arange(cache.shape[0], device=cache.device)
        cache[bidx, pos.long()] = new.to(cache.dtype)
        return
    spec = spec_of(cache)
    nl = to_local_as(new, (spec[0], *spec[2:])).to(cache.dtype)
    pl = to_local_as(pos, (spec[0],)).long()
    cl = cache.to_local()
    S_l = cl.shape[1]
    i = pl - (axis_index(spec[1]) * S_l if spec[1] else 0)
    ok = (i >= 0) & (i < S_l)
    i = i.clamp(0, S_l - 1)
    bidx = torch.arange(cl.shape[0], device=cl.device)
    keep = ok.reshape(-1, *[1] * (nl.dim() - 1))
    cl[bidx, i] = torch.where(keep, nl, cl[bidx, i])


def write_prefix(cache, new) -> None:
    """``cache[:, :S] = new`` in place (cache ``[B, S_max, ...]``, new
    ``[B, S, ...]``), on the shards of a sharded cache that hold those
    rows."""
    S = new.shape[1]
    if not is_dtensor(cache):
        cache[:, :S] = new.to(cache.dtype)
        return
    spec = spec_of(cache)
    nl = to_local_as(new, (spec[0], None, *spec[2:])).to(cache.dtype)
    cl = cache.to_local()
    S_l = cl.shape[1]
    lo = axis_index(spec[1]) * S_l if spec[1] else 0
    hi = min(lo + S_l, S)
    if hi > lo:
        cl[:, :hi - lo] = nl[:, lo:hi]


def append_kv(cfg, p, x, k_cache, v_cache, pos):
    """Project this token's k, v and write them into the cache at ``pos``.

    The write is in place into the preallocated cache (the reference
    returns updated copies); the same tensors are returned.
    """
    B = x.shape[0]
    KV, Dh = cfg.n_kv_heads, cfg.head_dim
    dt = x.dtype
    k = split_heads(x @ p["wk"].to(dt), B, 1, KV, Dh)
    v = split_heads(x @ p["wv"].to(dt), B, 1, KV, Dh)
    if cfg.qk_norm:
        k = rmsnorm(k, p["k_norm"])
    if cfg.pos == "rope":
        k = apply_rope(k, pos[:, None], cfg.rope_theta)
    write_rows(k_cache, k[:, 0], pos)
    write_rows(v_cache, v[:, 0], pos)
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
    return split_heads(q, *x.shape[:2], cfg.n_heads, m.qk_nope + m.qk_rope)


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
    k_nope = split_heads(c_kv @ p["wk_b"].to(dt), B, S, H, m.qk_nope)
    v = split_heads(c_kv @ p["wv_b"].to(dt), B, S, H, m.v_dim)
    q_rope = apply_rope(q_rope, pos, cfg.rope_theta)
    k_rope = apply_rope(k_rope, pos, cfg.rope_theta)
    k_rope1 = k_rope[:, :, 0, :]                             # cached (roped)
    k_rope = k_rope.expand(B, S, H, m.qk_rope)
    q = shard(torch.cat([q_nope, q_rope], dim=-1), "batch", "seq", "heads",
              None)
    k = shard(torch.cat([k_nope, k_rope], dim=-1), "batch", "seq", "heads",
              None)
    v = shard(v, "batch", "seq", "heads", None)
    return q, k, v, (c_kv, k_rope1)


def mla_attention(cfg, p, x, pos):
    """Full-sequence MLA (prefill): decompress, then SDPA over the
    decompressed heads (a GQA group of 1)."""
    q, k, v, _ = _mla_qkv(cfg, p, x, pos)
    o = _mla_sdpa(cfg, q, k, v)
    B, S = x.shape[:2]
    out = merge_heads(o, B, S, cfg.n_heads * cfg.mla.v_dim) @ \
        p["wo"].to(x.dtype)
    return shard(out, "batch", "seq", "embed")


def _mla_sdpa(cfg, q, k, v):
    """Causal SDPA where the q/k head dim differs from v's (reference
    ``attention.py:468-482``): the chunked or unrolled loop when
    ``S > attn_chunk`` under those impls, the full score matrix
    otherwise (``pallas`` too: MLA has no kernel).  Under a sharding
    context, on each rank's local heads."""
    if current_ctx() is None:
        return _mla_sdpa_local(cfg, q, k, v)
    b, hp = pspec("batch")[0], pspec("heads")[0]
    spec = (b, None, hp if _local_heads(q.shape[2], q.shape[2])[0]
            else None, None)
    return from_local_as(_mla_sdpa_local(cfg, *(to_local_as(t, spec)
                                                for t in (q, k, v))), spec)


def _mla_sdpa_local(cfg, q, k, v):
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


def _mla_scores_local(q_lat, q_rope, c_kv, k_rope, pos, scale, t):
    """Masked f32 latent scores ``[B,H,T]`` of a cache slice whose rows
    sit at global positions ``t``; the two terms are added in the
    activation dtype before the f32 cast, as in the reference."""
    s = torch.einsum("bhr,btr->bht", q_lat, c_kv)
    s = s + torch.einsum("bhn,btn->bht", q_rope, k_rope)
    s = s.float() * scale
    return torch.where((t[None, :] <= pos[:, None])[:, None, :], s, NEG_INF)


def _mla_flash_decode_sharded(q_lat, q_rope, c_kv_cache, k_rope_cache,
                              pos, scale, axes):
    """MLA flash-decode over a seq-sharded latent cache (reference
    ``attention.py:627-661``): :func:`_flash_decode_sharded` in the latent
    space."""
    b = pspec("batch")[0]
    whole = (b, None, None)
    ql, qr = to_local_as(q_lat, whole), to_local_as(q_rope, whole)
    seq = (b, _axes_spec(axes), None)
    ckv, kr = to_local_as(c_kv_cache, seq), to_local_as(k_rope_cache, seq)
    pl = to_local_as(pos, (b,))
    S_l = ckv.shape[1]
    t = axis_index(axes) * S_l + torch.arange(S_l, device=ckv.device)
    s = _mla_scores_local(ql, qr, ckv, kr, pl, scale, t)
    m = all_reduce(s.amax(dim=-1), "max", axes)
    p = torch.exp(s - m[..., None])
    l = all_reduce(p.sum(dim=-1), "sum", axes)
    o = torch.einsum("bht,btr->bhr", p.to(ql.dtype), ckv)
    o = all_reduce(o.float(), "sum", axes)
    return from_local_as((o / l.clamp_min(1e-30)[..., None]).to(ql.dtype),
                         whole)


def mla_decode(cfg, p, x, c_kv_cache, k_rope_cache, pos):
    """One-token MLA decode with weight absorption (reference
    ``attention.py:584-624``).  x: ``[B,1,D]``; c_kv_cache
    ``[B,S_max,kv_lora]`` and k_rope_cache ``[B,S_max,qk_rope]`` already
    hold this token at ``pos`` ``[B]``.  Scores in the latent space::

      q_lat = q_nope @ W_kb                    [B,H,kv_lora]
      s     = q_lat · c_kv + q_rope · k_rope   [B,H,S]
      o_lat = softmax(s) · c_kv                [B,H,kv_lora]
      o     = o_lat @ W_vb                     [B,H,v_dim]

    Under a sharding context the absorbed products run on each rank's
    batch shard with every head (the reference's flash-decode takes the
    heads whole), over a seq-sharded cache through
    :func:`_mla_flash_decode_sharded`.
    """
    m, H = cfg.mla, cfg.n_heads
    B = x.shape[0]
    dt = x.dtype
    scale = 1.0 / math.sqrt(m.qk_nope + m.qk_rope)
    b = pspec("batch")[0] if current_ctx() is not None else None
    whole = (b, None, None)
    q = to_local_as(split_heads(_mla_q(cfg, p, x), B, 1, H,
                                m.qk_nope + m.qk_rope)[:, 0], whole)
    pl = to_local_as(pos, (b,))
    q_nope, q_rope = q[..., :m.qk_nope], q[..., m.qk_nope:]
    q_rope = apply_rope(q_rope[:, None], pl[:, None], cfg.rope_theta)[:, 0]
    wk_b = to_local_as(p["wk_b"].to(dt), (None, None))
    q_lat = torch.einsum("bhn,rhn->bhr", q_nope,
                         wk_b.reshape(m.kv_lora, H, m.qk_nope))  # absorb W_kb
    axes = cache_seq_axes(cfg) if cfg.flash_decode else None
    if axes:
        o_lat = to_local_as(_mla_flash_decode_sharded(
            from_local_as(q_lat, whole), from_local_as(q_rope, whole),
            c_kv_cache, k_rope_cache, pos, scale, axes), whole)
    else:
        ckv = to_local_as(c_kv_cache, whole)
        t = torch.arange(ckv.shape[1], device=x.device)
        s = _mla_scores_local(q_lat, q_rope, ckv,
                              to_local_as(k_rope_cache, whole), pl, scale, t)
        o_lat = torch.einsum("bht,btr->bhr",
                             torch.softmax(s, dim=-1).to(dt), ckv)
    wv_b = to_local_as(p["wv_b"].to(dt), (None, None))
    o = torch.einsum("bhr,rhv->bhv", o_lat,
                     wv_b.reshape(m.kv_lora, H, m.v_dim))
    o = from_local_as(o.reshape(o.shape[0], H * m.v_dim), (b, None))
    return (o @ p["wo"].to(dt))[:, None, :]


def mla_append_kv(cfg, p, x, c_kv_cache, k_rope_cache, pos):
    """Write this token's latent and rotated shared key into the caches
    at ``pos``, in place; the same tensors are returned."""
    m = cfg.mla
    kv = x @ p["wkv_a"].to(x.dtype)
    c_kv = rmsnorm(kv[..., :m.kv_lora], p["kv_a_norm"])[:, 0]
    k_rope = apply_rope(kv[..., m.kv_lora:][:, :, None, :], pos[:, None],
                        cfg.rope_theta)[:, 0, 0]
    write_rows(c_kv_cache, c_kv, pos)
    write_rows(k_rope_cache, k_rope, pos)
    return c_kv_cache, k_rope_cache
