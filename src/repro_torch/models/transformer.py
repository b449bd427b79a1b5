"""Model assembly: blocks → layer stack (a Python loop) → LM API.

Counterpart of ``repro/models/transformer.py`` for ``family="dense"``
without MoE or MLA.  ``build_model(cfg, device)`` returns a :class:`Model`
of plain functions:

* ``init(generator) → params`` — ``{"embed", "layers": [one dict per
  layer], "final_norm"}`` on the generator's device;
* ``forward(params, tokens) → (logits, aux)`` — full sequence;
* ``init_cache / prefill / decode_step`` — the serving path.  The cache
  is the reference's ``{"k", "v"}`` of ``[L, B, max_len, KV, Dh]``;
  ``prefill`` and ``decode_step`` write it in place and return it.

The reference's ``lax.scan`` over stacked layers is a Python loop here.
``loss``, remat, ``param_specs`` and ``layer_mode`` belong to training,
sharding and the roofline and are not ported yet; the ``rwkv6`` and
``hybrid`` families and ``moe`` / ``mla`` blocks raise
:class:`NotPortedError`.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch import NotPortedError
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models.common import ModelCfg
from repro_torch.models.layers import (apply_norm, embed, init_embed,
                                       init_mlp, lm_logits, mlp,
                                       sinusoidal_at, sinusoidal_pe, zeros)


class Model(NamedTuple):
    cfg: ModelCfg
    device: torch.device
    init: Callable          # (generator) -> params
    forward: Callable       # (params, tokens) -> (logits, aux)
    init_cache: Callable    # (batch, max_len) -> cache
    prefill: Callable       # (params, tokens, cache) -> (logits, cache)
    decode_step: Callable   # (params, tok[B,1], cache, pos[B]) -> (logits, cache)


def check_ported(cfg: ModelCfg) -> None:
    """Raise :class:`NotPortedError` for what this slice does not run."""
    if cfg.family in ("rwkv6", "hybrid"):
        raise NotPortedError(f"family {cfg.family!r} ({cfg.name}) is not "
                             f"ported to repro_torch yet")
    for part in ("moe", "mla"):
        if getattr(cfg, part) is not None:
            raise NotPortedError(f"{part} blocks ({cfg.name}) are not "
                                 f"ported to repro_torch yet")
    attn.check_attn_impl(cfg)


# ---------------------------------------------------------------------------
# Dense transformer block
# ---------------------------------------------------------------------------

def init_dense_block(gen: torch.Generator, cfg) -> dict:
    p = {}
    if cfg.norm != "layernorm_np":
        p["ln1s"] = zeros(gen, (cfg.d_model,), cfg.p_dtype)
        p["ln2s"] = zeros(gen, (cfg.d_model,), cfg.p_dtype)
    p["attn"] = attn.init_attention(gen, cfg)
    p["mlp"] = init_mlp(gen, cfg)
    return p


def dense_block(cfg, p, x, pos):
    """Full-seq block.  Returns ``(x, (k, v))``."""
    h = apply_norm(cfg, x, p.get("ln1s"))
    q, k, v = attn._qkv(cfg, p["attn"], h, pos)
    o = attn.sdpa(cfg, q, k, v)
    B, S = x.shape[:2]
    x = x + o.reshape(B, S, cfg.q_dim) @ p["attn"]["wo"].to(x.dtype)
    h = apply_norm(cfg, x, p.get("ln2s"))
    return x + mlp(cfg, p["mlp"], h), (k, v)


def dense_block_decode(cfg, p, x, k_cache, v_cache, pos):
    """One-token block; writes this token's k, v into the layer's cache."""
    h = apply_norm(cfg, x, p.get("ln1s"))
    attn.append_kv(cfg, p["attn"], h, k_cache, v_cache, pos)
    x = x + attn.decode_attention(cfg, p["attn"], h, k_cache, v_cache, pos)
    h = apply_norm(cfg, x, p.get("ln2s"))
    return x + mlp(cfg, p["mlp"], h)


# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------

def build_model(cfg: ModelCfg, device=None) -> Model:
    """The dense LM API of ``cfg`` on ``device`` (``None`` = CUDA)."""
    check_ported(cfg)
    dev = resolve_device(device)

    def init(gen: torch.Generator) -> dict:
        if gen.device.type != dev.type:
            raise ValueError(f"init: the generator is on {gen.device}, the "
                             f"model on {dev}")
        return {
            "embed": init_embed(gen, cfg),
            "layers": [init_dense_block(gen, cfg)
                       for _ in range(cfg.n_layers)],
            "final_norm": (zeros(gen, (cfg.d_model,), cfg.p_dtype)
                           if cfg.norm == "rmsnorm"
                           else zeros(gen, (0,), torch.float32)),
        }

    def _final(params, x):
        return apply_norm(cfg, x, params["final_norm"]
                          if cfg.norm == "rmsnorm" else None)

    def _embed_in(params, tokens):
        x = embed(cfg, params["embed"], tokens)
        if cfg.pos == "sinusoidal":
            x = x + sinusoidal_pe(tokens.shape[1], cfg.d_model,
                                  device=x.device).to(x.dtype)[None]
        return x

    def _stack(params, tokens, cache=None):
        x = _embed_in(params, tokens)
        pos = torch.arange(tokens.shape[1], device=tokens.device)
        for i, p_l in enumerate(params["layers"]):
            x, (k, v) = dense_block(cfg, p_l, x, pos)
            if cache is not None:
                S = tokens.shape[1]
                cache["k"][i, :, :S] = k.to(cache["k"].dtype)
                cache["v"][i, :, :S] = v.to(cache["v"].dtype)
        return _final(params, x)

    def forward(params, tokens):
        x = _stack(params, tokens)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        return lm_logits(cfg, params["embed"], x), aux

    def init_cache(batch: int, max_len: int) -> dict:
        return attn.init_kv_cache(cfg, batch, max_len, device=dev)

    def prefill(params, tokens, cache):
        """Logits of the last prompt token; the prompt's k, v written into
        ``cache[:, :, :S]`` in place."""
        x = _stack(params, tokens, cache)
        return lm_logits(cfg, params["embed"], x[:, -1:]), cache

    def decode_step(params, tok, cache, pos):
        """tok ``[B, 1]`` at positions ``pos`` ``[B]`` int32 → logits
        ``[B, 1, V]``; writes the token's k, v into the cache in place."""
        x = embed(cfg, params["embed"], tok)
        if cfg.pos == "sinusoidal":
            x = x + sinusoidal_at(pos, cfg.d_model).to(x.dtype)[:, None]
        for i, p_l in enumerate(params["layers"]):
            x = dense_block_decode(cfg, p_l, x, cache["k"][i],
                                   cache["v"][i], pos)
        x = _final(params, x)
        return lm_logits(cfg, params["embed"], x), cache

    return Model(cfg, dev, init, forward, init_cache, prefill, decode_step)
