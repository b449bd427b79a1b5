"""Model assembly: blocks → layer stack (a Python loop) → LM API.

Counterpart of ``repro/models/transformer.py`` for every family: dense
and MoE blocks (with GQA or MLA attention), ``rwkv6`` and ``hybrid``
(zamba2).  ``build_model(cfg, device)`` returns a :class:`Model` of
plain functions:

* ``init(generator) → params`` — ``{"embed", "layers": [one dict per
  layer], "final_norm"}`` (and the hybrid's ``"shared"`` attention block)
  on the generator's device;
* ``forward(params, tokens) → (logits, aux)`` — full sequence; ``aux`` is
  the MoE router losses summed over layers (0 without MoE);
* ``loss(params, tokens, labels)`` — mean cross-entropy plus ``aux``;
  ``forward`` and ``loss`` are functional (a recurrent layer starts from
  a fresh zero state and returns its new one, which they drop), so
  autograd runs through them;
* ``init_cache / prefill / decode_step`` — the serving path.  The cache
  is the reference's: ``{"k", "v"}`` of ``[L, B, max_len, KV, Dh]``
  (dense), MLA's latent ``{"c_kv", "k_rope"}`` of ``[L, B, max_len,
  kv_lora | qk_rope]``, the recurrent state ``{"tm_shift", "cm_shift",
  "wkv"}`` stacked on ``L`` (rwkv6), or ``{"conv", "ssm"}`` plus the
  shared block's ``{"attn_k", "attn_v"}`` of ``[L // every, B, max_len,
  KV, Dh]`` (hybrid).  ``prefill`` and ``decode_step`` write it in place
  and return it.

The reference's ``lax.scan`` over stacked layers is a Python loop here,
with a static layer index (the reference's unrolled mode).  Under
training each layer runs under ``cfg.remat`` (:func:`_remat`).
``param_specs`` and ``layer_mode`` belong to sharding and the roofline
and are not ported yet.
"""
from __future__ import annotations

import functools
from typing import Callable, NamedTuple

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.device import resolve_device
from repro_torch.kernels.autograd import wants_grad
from repro_torch.models import attention as attn
from repro_torch.models import mamba2 as m2
from repro_torch.models import moe as moe_mod
from repro_torch.models import rwkv6 as rk
from repro_torch.models.common import ModelCfg
from repro_torch.models.layers import (apply_norm, embed, init_embed,
                                       init_mlp, lm_logits, mlp, rmsnorm,
                                       sinusoidal_at, sinusoidal_pe,
                                       softmax_xent, zeros)
from repro_torch.training.tree import tree_leaves


class Model(NamedTuple):
    cfg: ModelCfg
    device: torch.device
    init: Callable          # (generator) -> params
    forward: Callable       # (params, tokens) -> (logits, aux)
    loss: Callable          # (params, tokens, labels) -> xent + aux
    init_cache: Callable    # (batch, max_len) -> cache
    prefill: Callable       # (params, tokens, cache) -> (logits, cache)
    decode_step: Callable   # (params, tok[B,1], cache, pos[B]) -> (logits, cache)


def check_ported(cfg: ModelCfg) -> None:
    """Raise :class:`~repro_torch.NotPortedError` for an ``attn_impl``
    the port does not have; rwkv6 has no attention."""
    if cfg.family != "rwkv6":
        attn.check_attn_impl(cfg)


# ---------------------------------------------------------------------------
# Dense / MoE transformer block
# ---------------------------------------------------------------------------

def init_dense_block(gen: torch.Generator, cfg) -> dict:
    p = {}
    if cfg.norm != "layernorm_np":
        p["ln1s"] = zeros(gen, (cfg.d_model,), cfg.p_dtype)
        p["ln2s"] = zeros(gen, (cfg.d_model,), cfg.p_dtype)
    p["attn"] = attn.init_mla(gen, cfg) if cfg.mla else \
        attn.init_attention(gen, cfg)
    p["mlp"] = moe_mod.init_moe(gen, cfg) if cfg.moe else init_mlp(gen, cfg)
    return p


def _block_mlp(cfg, p, x, *, decode: bool):
    """The block's MLP or MoE: ``(y, aux)``."""
    if cfg.moe is not None:
        return moe_mod.moe(cfg, p["mlp"], x, decode=decode)
    return mlp(cfg, p["mlp"], x), _zero(x)


def dense_block(cfg, p, x, pos):
    """Full-seq block.  Returns ``(x, kv, aux)``: ``kv`` is the layer's
    cache entries over the sequence by cache name (``k``/``v``, or MLA's
    ``c_kv``/``k_rope``)."""
    h = apply_norm(cfg, x, p.get("ln1s"))
    B, S = x.shape[:2]
    if cfg.mla is not None:
        q, k, v, (c_kv, k_rope) = attn._mla_qkv(cfg, p["attn"], h, pos)
        o = attn._mla_sdpa(cfg, q, k, v)
        a = o.reshape(B, S, cfg.n_heads * cfg.mla.v_dim) @ \
            p["attn"]["wo"].to(x.dtype)
        kv = {"c_kv": c_kv, "k_rope": k_rope}
    else:
        q, k, v = attn._qkv(cfg, p["attn"], h, pos)
        o = attn.sdpa(cfg, q, k, v)
        a = o.reshape(B, S, cfg.q_dim) @ p["attn"]["wo"].to(x.dtype)
        kv = {"k": k, "v": v}
    x = x + a
    h = apply_norm(cfg, x, p.get("ln2s"))
    y, aux = _block_mlp(cfg, p, h, decode=False)
    return x + y, kv, aux


def dense_block_decode(cfg, p, x, cache_l: dict, pos):
    """One-token block; writes this token's cache entries into the
    layer's cache ``cache_l`` (``{name: [B, max_len, ...]}``) in place."""
    h = apply_norm(cfg, x, p.get("ln1s"))
    if cfg.mla is not None:
        attn.mla_append_kv(cfg, p["attn"], h, cache_l["c_kv"],
                           cache_l["k_rope"], pos)
        a = attn.mla_decode(cfg, p["attn"], h, cache_l["c_kv"],
                            cache_l["k_rope"], pos)
    else:
        attn.append_kv(cfg, p["attn"], h, cache_l["k"], cache_l["v"], pos)
        a = attn.decode_attention(cfg, p["attn"], h, cache_l["k"],
                                  cache_l["v"], pos)
    x = x + a
    h = apply_norm(cfg, x, p.get("ln2s"))
    return x + _block_mlp(cfg, p, h, decode=True)[0]


# ---------------------------------------------------------------------------
# zamba2 hybrid: the shared attention block
# ---------------------------------------------------------------------------

def init_hybrid_shared(gen: torch.Generator, cfg) -> dict:
    return {"ln1": zeros(gen, (cfg.d_model,), cfg.p_dtype),
            "ln2": zeros(gen, (cfg.d_model,), cfg.p_dtype),
            "attn": attn.init_attention(gen, cfg),
            "mlp": init_mlp(gen, cfg)}


def shared_attn_block(cfg, sp, x, pos):
    """Full-seq shared block.  Returns ``(x, (k, v))``."""
    h = rmsnorm(x, sp["ln1"])
    q, k, v = attn._qkv(cfg, sp["attn"], h, pos)
    o = attn.sdpa(cfg, q, k, v)
    B, S = x.shape[:2]
    x = x + o.reshape(B, S, cfg.q_dim) @ sp["attn"]["wo"].to(x.dtype)
    x = x + mlp(cfg, sp["mlp"], rmsnorm(x, sp["ln2"]))
    return x, (k, v)


def shared_attn_decode(cfg, sp, x, k_c, v_c, pos):
    """One-token shared block; writes this token's k, v into its cache
    ``k_c``/``v_c`` ``[B, max_len, KV, Dh]`` in place."""
    h = rmsnorm(x, sp["ln1"])
    attn.append_kv(cfg, sp["attn"], h, k_c, v_c, pos)
    x = x + attn.decode_attention(cfg, sp["attn"], h, k_c, v_c, pos)
    return x + mlp(cfg, sp["mlp"], rmsnorm(x, sp["ln2"]))


# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------

def build_model(cfg: ModelCfg, device=None) -> Model:
    """The LM API of ``cfg`` on ``device`` (``None`` = CUDA)."""
    check_ported(cfg)
    dev = resolve_device(device)
    if cfg.family == "rwkv6":
        return _build_rwkv(cfg, dev)
    if cfg.family == "hybrid":
        return _build_hybrid(cfg, dev)
    return _build_dense(cfg, dev)


def _check_generator(gen: torch.Generator, dev: torch.device) -> None:
    if gen.device.type != dev.type:
        raise ValueError(f"init: the generator is on {gen.device}, the "
                         f"model on {dev}")


def _embed_in(cfg, params, tokens):
    x = embed(cfg, params["embed"], tokens)
    if cfg.pos == "sinusoidal":
        x = x + sinusoidal_pe(tokens.shape[1], cfg.d_model,
                              device=x.device).to(x.dtype)[None]
    return x


def _zero(x):
    return torch.zeros((), dtype=torch.float32, device=x.device)


def _loss(forward):
    """``loss(params, tokens, labels)``: mean cross-entropy plus the
    forward's ``aux``."""
    def loss(params, tokens, labels):
        logits, aux = forward(params, tokens)
        return softmax_xent(logits, labels) + aux
    return loss


def _layer_state(state: dict, i: int) -> dict:
    return {k: v[i] for k, v in state.items()}


def _write_state(state: dict, i: int, new: dict) -> None:
    for k, v in new.items():
        state[k][i].copy_(v)


# -- rematerialisation (training only) ---------------------------------------

#: the products the reference's ``checkpoint_dots`` policy keeps
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default)


def _keep_dots(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(cfg, fn):
    """One layer ``fn(p_l, *args)`` under ``cfg.remat`` (the reference's
    ``_remat``): ``"full"`` keeps the layer's inputs and recomputes the
    rest in the backward, ``"dots"`` keeps its matrix products too
    (``checkpoint_dots``), ``"none"`` keeps everything.  It acts only when
    grad mode is on and a parameter of the layer requires a gradient, so
    serving runs ``fn`` as it is."""
    if cfg.remat == "none":
        return fn
    kw = {} if cfg.remat == "full" else {"context_fn": functools.partial(
        create_selective_checkpoint_contexts, _keep_dots)}

    def layer(p_l, *args):
        if not wants_grad(*tree_leaves(p_l)):
            return fn(p_l, *args)
        return checkpoint(fn, p_l, *args, use_reentrant=False, **kw)
    return layer


# -- dense ------------------------------------------------------------------

def _build_dense(cfg: ModelCfg, dev: torch.device) -> Model:
    def init(gen: torch.Generator) -> dict:
        _check_generator(gen, dev)
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

    def _stack(params, tokens, cache=None):
        """The layer stack over ``tokens``: ``(x, aux)``; with a cache,
        every layer's cache entries written into ``[:, :, :S]``."""
        x = _embed_in(cfg, params, tokens)
        S = tokens.shape[1]
        pos = torch.arange(S, device=tokens.device)
        aux = _zero(x)
        block = _remat(cfg, lambda p_l, x: dense_block(cfg, p_l, x, pos))
        for i, p_l in enumerate(params["layers"]):
            x, kv, a = block(p_l, x)
            aux = aux + a
            if cache is not None:
                for name, t in kv.items():
                    cache[name][i, :, :S] = t.to(cache[name].dtype)
        return _final(params, x), aux

    def forward(params, tokens):
        x, aux = _stack(params, tokens)
        return lm_logits(cfg, params["embed"], x), aux

    def init_cache(batch: int, max_len: int) -> dict:
        if cfg.mla is not None:
            return attn.init_mla_cache(cfg, batch, max_len, device=dev)
        return attn.init_kv_cache(cfg, batch, max_len, device=dev)

    def prefill(params, tokens, cache):
        """Logits of the last prompt token; the prompt's cache entries
        written into ``cache[:, :, :S]`` in place."""
        x, _ = _stack(params, tokens, cache)
        return lm_logits(cfg, params["embed"], x[:, -1:]), cache

    def decode_step(params, tok, cache, pos):
        """tok ``[B, 1]`` at positions ``pos`` ``[B]`` int32 → logits
        ``[B, 1, V]``; writes the token's cache entries in place."""
        x = embed(cfg, params["embed"], tok)
        if cfg.pos == "sinusoidal":
            x = x + sinusoidal_at(pos, cfg.d_model).to(x.dtype)[:, None]
        for i, p_l in enumerate(params["layers"]):
            x = dense_block_decode(cfg, p_l, x, _layer_state(cache, i), pos)
        x = _final(params, x)
        return lm_logits(cfg, params["embed"], x), cache

    return Model(cfg, dev, init, forward, _loss(forward), init_cache,
                 prefill, decode_step)


# -- rwkv6 ------------------------------------------------------------------

def _build_rwkv(cfg: ModelCfg, dev: torch.device) -> Model:
    def init(gen: torch.Generator) -> dict:
        _check_generator(gen, dev)
        return {"embed": init_embed(gen, cfg),
                "layers": [rk.init_rwkv_block(gen, cfg)
                           for _ in range(cfg.n_layers)],
                "final_norm": zeros(gen, (cfg.d_model,), cfg.p_dtype)}

    block = _remat(cfg, lambda p_l, x, st: rk.rwkv_block(
        cfg, p_l, x, st, chunk=cfg.rwkv.chunk))

    def _run(params, x, state, write=False):
        """The layer stack from ``state`` (layer i reads ``state[k][i]``);
        with ``write`` (the serving path) each layer's new state is written
        back into ``state`` in place, else dropped."""
        for i, p_l in enumerate(params["layers"]):
            x, new = block(p_l, x, _layer_state(state, i))
            if write:
                _write_state(state, i, new)
        return x

    def forward(params, tokens):
        x = _embed_in(cfg, params, tokens)
        x = _run(params, x, rk.init_rwkv_state(cfg, tokens.shape[0],
                                               device=x.device))
        x = rmsnorm(x, params["final_norm"])
        return lm_logits(cfg, params["embed"], x), _zero(x)

    def init_cache(batch: int, max_len: int) -> dict:
        return rk.init_rwkv_state(cfg, batch, device=dev)   # O(1) in max_len

    def prefill(params, tokens, cache):
        """Logits of the last prompt token; the state advanced over the
        prompt in place."""
        x = _run(params, _embed_in(cfg, params, tokens), cache, write=True)
        x = rmsnorm(x[:, -1:], params["final_norm"])
        return lm_logits(cfg, params["embed"], x), cache

    def decode_step(params, tok, cache, pos):
        """tok ``[B, 1]`` → logits ``[B, 1, V]``; the state advanced one
        token in place (``pos`` is not needed)."""
        x = _run(params, embed(cfg, params["embed"], tok), cache,
                 write=True)
        x = rmsnorm(x, params["final_norm"])
        return lm_logits(cfg, params["embed"], x), cache

    return Model(cfg, dev, init, forward, _loss(forward), init_cache,
                 prefill, decode_step)


# -- zamba2 hybrid ----------------------------------------------------------

def _build_hybrid(cfg: ModelCfg, dev: torch.device) -> Model:
    every = cfg.hybrid_attn_every
    n_attn = cfg.n_layers // every if every else 0

    def init(gen: torch.Generator) -> dict:
        _check_generator(gen, dev)
        return {"embed": init_embed(gen, cfg),
                "layers": [{"m": m2.init_mamba2(gen, cfg),
                            "ln": zeros(gen, (cfg.d_model,), cfg.p_dtype)}
                           for _ in range(cfg.n_layers)],
                "shared": init_hybrid_shared(gen, cfg),
                "final_norm": zeros(gen, (cfg.d_model,), cfg.p_dtype)}

    def _run(params, x, state, shared, write=False):
        """Mamba layers from ``state`` (layer li reads ``state[k][li]``);
        after every ``every``-th layer ``shared(x, ai)`` runs the shared
        block for its ``ai``-th time; with ``write`` (the serving path)
        each layer's new state is written back into ``state`` in place,
        else dropped."""
        def layer(p_l, x, st, li):
            y, new = m2.mamba2_block(cfg, p_l["m"], rmsnorm(x, p_l["ln"]), st)
            x = x + y
            if every and li % every == every - 1:
                x = shared(x, li // every)
            return x, new

        layer = _remat(cfg, layer)
        for li, p_l in enumerate(params["layers"]):
            x, new = layer(p_l, x, _layer_state(state, li), li)
            if write:
                _write_state(state, li, new)
        return x

    def forward(params, tokens):
        x = _embed_in(cfg, params, tokens)
        pos = torch.arange(tokens.shape[1], device=tokens.device)
        x = _run(params, x, m2.init_mamba_state(cfg, tokens.shape[0],
                                                device=x.device),
                 lambda x, ai: shared_attn_block(cfg, params["shared"], x,
                                                 pos)[0])
        x = rmsnorm(x, params["final_norm"])
        return lm_logits(cfg, params["embed"], x), _zero(x)

    def init_cache(batch: int, max_len: int) -> dict:
        c = m2.init_mamba_state(cfg, batch, device=dev)
        c["attn_k"] = torch.zeros(
            (n_attn, batch, max_len, cfg.n_kv_heads, cfg.head_dim),
            dtype=cfg.act_dtype, device=dev)
        c["attn_v"] = torch.zeros_like(c["attn_k"])
        return c

    def prefill(params, tokens, cache):
        """Logits of the last prompt token; the state advanced over the
        prompt and the shared block's k, v written into
        ``cache["attn_k"/"attn_v"][:, :, :S]``, in place."""
        S = tokens.shape[1]
        pos = torch.arange(S, device=tokens.device)
        state = {k: cache[k] for k in ("conv", "ssm")}

        def shared(x, ai):
            x, (k, v) = shared_attn_block(cfg, params["shared"], x, pos)
            cache["attn_k"][ai, :, :S] = k.to(cache["attn_k"].dtype)
            cache["attn_v"][ai, :, :S] = v.to(cache["attn_v"].dtype)
            return x

        x = _run(params, _embed_in(cfg, params, tokens), state, shared,
                 write=True)
        x = rmsnorm(x[:, -1:], params["final_norm"])
        return lm_logits(cfg, params["embed"], x), cache

    def decode_step(params, tok, cache, pos):
        """tok ``[B, 1]`` at positions ``pos`` ``[B]`` int32 → logits
        ``[B, 1, V]``; the state advanced one token and the token's k, v
        written into the shared block's cache, in place."""
        state = {k: cache[k] for k in ("conv", "ssm")}
        x = _run(params, embed(cfg, params["embed"], tok), state,
                 lambda x, ai: shared_attn_decode(
                     cfg, params["shared"], x, cache["attn_k"][ai],
                     cache["attn_v"][ai], pos), write=True)
        x = rmsnorm(x, params["final_norm"])
        return lm_logits(cfg, params["embed"], x), cache

    return Model(cfg, dev, init, forward, _loss(forward), init_cache,
                 prefill, decode_step)
