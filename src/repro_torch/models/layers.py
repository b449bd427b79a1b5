"""Shared neural building blocks (pure functions over param dicts).

Counterpart of ``repro/models/layers.py``.  Conventions:

* params are nested dicts of tensors, one dict per layer (the reference
  stacks layers on a leading ``L`` axis for ``lax.scan``; the port loops
  over a list);
* compute runs in ``cfg.act_dtype`` (bf16 by default); params are stored in
  ``cfg.p_dtype`` (f32) and cast at use, with the reference's f32 upcasts
  in the same places (norms, RoPE);
* initialisers draw from an explicit ``torch.Generator`` and create the
  tensor on the generator's device (:data:`META`, a stand-in on the
  ``meta`` device, gives shapes without allocating).  The two frameworks
  draw different numbers from one seed: the tests carry the reference's
  weights across with :func:`repro_torch.convert.params_from_reference`;
* the reference's logical sharding constraints
  (:func:`repro_torch.distribution.sharding.shard`) stand at its places;
  without a sharding context they do nothing.
"""
from __future__ import annotations

import math

import types

import torch
import torch.nn.functional as F

from repro_torch.distribution.sharding import is_dtensor, shard

#: a generator stand-in on the ``meta`` device: initialisers given it
#: build shapes and dtypes only (``repro_torch.launch.specs``)
META = types.SimpleNamespace(device=torch.device("meta"))


# ---------------------------------------------------------------------------
# Initializers
# ---------------------------------------------------------------------------

def randn(gen, shape) -> torch.Tensor:
    """A standard-normal draw from ``gen`` on its device (shapes only on
    :data:`META`)."""
    if gen.device.type == "meta":
        return torch.randn(shape, device="meta")
    return torch.randn(shape, generator=gen, device=gen.device)


def dense_init(gen: torch.Generator, shape, dtype, *, in_axis: int = -2
               ) -> torch.Tensor:
    """LeCun-normal in the contraction dim: normal / sqrt(fan_in)."""
    fan_in = shape[in_axis]
    x = randn(gen, shape)
    # in place: an f32 draw of a full-width expert tensor is ~5 GB
    return x.div_(math.sqrt(fan_in)).to(dtype)


def embed_init(gen: torch.Generator, shape, dtype) -> torch.Tensor:
    x = randn(gen, shape)
    return (x * 0.02).to(dtype)


def zeros(gen: torch.Generator, shape, dtype) -> torch.Tensor:
    """Zeros on the generator's device (norm scales start at zero)."""
    return torch.zeros(shape, dtype=dtype, device=gen.device)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rmsnorm(x: torch.Tensor, scale: torch.Tensor | None, eps: float = 1e-6
            ) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps)
    if scale is not None:
        x = x * (1.0 + scale.float())
    return x.to(dt)


def layernorm_np(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Non-parametric LayerNorm (OLMo): no scale, no bias."""
    dt = x.dtype
    x = x.float()
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    return ((x - mu) * torch.rsqrt(var + eps)).to(dt)


def apply_norm(cfg, x: torch.Tensor, scale: torch.Tensor | None
               ) -> torch.Tensor:
    if cfg.norm == "layernorm_np":
        return layernorm_np(x)
    return rmsnorm(x, scale)


# ---------------------------------------------------------------------------
# Positional encodings
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / torch.pow(theta, exps)


def apply_rope(x: torch.Tensor, pos: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """x: ``[..., S, H, Dh]``; pos: broadcastable to ``[..., S]`` (int)."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)     # [Dh/2]
    ang = pos[..., None].float() * freqs                  # [..., S, Dh/2]
    cos = torch.cos(ang)[..., None, :]                    # [..., S, 1, Dh/2]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def sinusoidal_at(pos: torch.Tensor, d_model: int) -> torch.Tensor:
    """Sinusoidal position embedding rows at positions ``pos`` ``[N]``
    → ``[N, d_model]`` f32 (sin on even, cos on odd channels)."""
    dim = torch.arange(0, d_model, 2, dtype=torch.float32,
                       device=pos.device)[None, :]
    ang = pos[:, None].float() / torch.pow(10000.0, dim / d_model)
    # interleaved by a stack, not written into a buffer: ``pos`` may be a
    # DTensor (a decode step's positions split over the batch)
    return torch.stack([torch.sin(ang), torch.cos(ang)], dim=-1).reshape(
        pos.shape[0], d_model)


def sinusoidal_pe(seq: int, d_model: int, offset: int = 0, device=None
                  ) -> torch.Tensor:
    """Classic transformer sinusoidal position embedding (musicgen)."""
    pos = torch.arange(offset, offset + seq, dtype=torch.float32,
                       device=device)
    return sinusoidal_at(pos, d_model)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def init_mlp(gen: torch.Generator, cfg, d_ff: int | None = None) -> dict:
    D = cfg.d_model
    Fd = d_ff or cfg.d_ff
    dt = cfg.p_dtype
    if cfg.mlp in ("swiglu", "geglu"):
        return {"w_gate": dense_init(gen, (D, Fd), dt),
                "w_in": dense_init(gen, (D, Fd), dt),
                "w_out": dense_init(gen, (Fd, D), dt)}
    return {"w_in": dense_init(gen, (D, Fd), dt),
            "w_out": dense_init(gen, (Fd, D), dt)}


def mlp(cfg, p: dict, x: torch.Tensor) -> torch.Tensor:
    """x: ``[B, S, D]`` → ``[B, S, D]``."""
    dt = x.dtype
    if cfg.mlp in ("swiglu", "geglu"):
        g = shard(x @ p["w_gate"].to(dt), "batch", "seq", "ff")
        h = shard(x @ p["w_in"].to(dt), "batch", "seq", "ff")
        act = F.silu(g) if cfg.mlp == "swiglu" else \
            F.gelu(g, approximate="tanh")
        h = act * h
    else:
        h = shard(x @ p["w_in"].to(dt), "batch", "seq", "ff")
        h = F.gelu(h, approximate="tanh")
    return shard(h @ p["w_out"].to(dt), "batch", "seq", "embed")


# ---------------------------------------------------------------------------
# Embedding / LM head
# ---------------------------------------------------------------------------

def init_embed(gen: torch.Generator, cfg) -> dict:
    p = {"tok": embed_init(gen, (cfg.vocab, cfg.d_model), cfg.p_dtype)}
    if not cfg.tie_embeddings:
        p["lm_head"] = dense_init(gen, (cfg.d_model, cfg.vocab), cfg.p_dtype)
    return p


def embed(cfg, p: dict, tokens: torch.Tensor) -> torch.Tensor:
    """Token rows in ``act_dtype``.  The rows are gathered, then cast (the
    reference casts the table, then gathers: the same values, without a
    cast of the whole table per call).  A sharded table (a DTensor) is
    read through ``embedding``, which DTensor shards over the vocab."""
    if is_dtensor(p["tok"]) or is_dtensor(tokens):
        x = F.embedding(shard(tokens, "batch", "seq"), p["tok"])
        x = shard(x, "batch", "seq", "embed").to(cfg.act_dtype)
    else:
        x = p["tok"][tokens].to(cfg.act_dtype)
    if cfg.name.startswith("gemma"):
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=cfg.act_dtype,
                             device=x.device)
    return shard(x, "batch", "seq", "embed")


def lm_logits(cfg, p: dict, x: torch.Tensor) -> torch.Tensor:
    """The logits of ``x`` ``[B, S, D]``, its sequence gathered first
    where a sequence-parallel residual split it (a no-op otherwise)."""
    w = p["tok"].T if cfg.tie_embeddings else p["lm_head"]
    logits = shard(x, "batch", "seq", "embed") @ w.to(x.dtype)
    if cfg.logit_softcap > 0.0:
        c = cfg.logit_softcap
        logits = torch.tanh(logits / c) * c
    return shard(logits, "batch", "seq", "vocab")


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy with an f32 reduction; labels < 0 are masked.
    Sharded logits are gathered over the vocab first, with the labels laid
    out by batch beside them."""
    if is_dtensor(logits):
        logits = shard(logits, "batch", "seq", None)
        labels = shard(labels, "batch", "seq")
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = logits.gather(-1, labels.clamp_min(0)[..., None].long())[..., 0]
    mask = (labels >= 0).float()
    return ((lse - ll) * mask).sum() / mask.sum().clamp_min(1.0)
