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

* ``param_specs() / cache_specs(batch, max_len)`` — the logical
  shardings of the parameters and the cache under the active sharding
  context (:mod:`repro_torch.distribution.sharding`), as specs (a tuple of
  mesh axes a dim).  The parameters keep one dict a layer where the
  reference stacks them on a leading ``L`` axis, so a layer's spec is the
  reference's without its leading ``None``; the caches keep the
  reference's stacked layout and its specs.

The reference's ``lax.scan`` over stacked layers is a Python loop here,
with a static layer index (the reference's unrolled mode): both
``layer_mode``s (``"scan"`` and ``"unroll"``) are that loop.  Under
training each layer runs under ``cfg.remat`` (:func:`_remat`).

Under a sharding context every family runs sharded: the parameters and
caches are DTensors laid out by their specs (or plain tensors, taken as
replicated), the tokens are laid out by batch, and the reference's
constraints stand at its places.  Attention, the MoE dispatch and the
recurrent scans (``rwkv6``'s WKV, the hybrid's SSD) are manual regions
on each rank's local heads or experts; ``prefill`` and ``decode_step``
write a sharded cache on the shards that hold it.
"""
from __future__ import annotations

import contextlib
import functools
from typing import Callable, NamedTuple

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.device import resolve_device
from repro_torch.distribution.sharding import (Spec, axis_size, current_ctx,
                                               full, heads_over_model,
                                               is_dtensor, phys,
                                               plain_as_replicated, pspec,
                                               shard, sharding_ctx, spec_of,
                                               to_local_as)
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
    param_specs: Callable   # () -> tree of specs
    cache_specs: Callable   # (batch, max_len) -> tree of specs


LAYER_MODES = ("scan", "unroll")


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


def _residual(t):
    """A block's output ``[B, S, D]`` in the residual's layout before it is
    added to it (a no-op but under a sequence-parallel residual): the
    gradient then comes back to the block's last product laid out as that
    product's output was, not split over the sequence (see
    :func:`_whole_seq`)."""
    return shard(t, "batch", "act_seq", "embed")


def _whole_seq(h):
    """``h`` ``[B, S, D]`` laid out with its sequence whole (a no-op but
    under a sequence-parallel residual): the sequence gathered before the
    projections that read it, as a sequence-parallel layer does, rather
    than left to DTensor, which cannot flatten a batch and a sequence both
    split (torch 2.11) or gathers the weights instead."""
    return shard(h, "batch", "seq", "embed")


def dense_block(cfg, p, x, pos):
    """Full-seq block.  Returns ``(x, kv, aux)``: ``kv`` is the layer's
    cache entries over the sequence by cache name (``k``/``v``, or MLA's
    ``c_kv``/``k_rope``).  Under a sequence-parallel residual
    (``act_seq``) each normed input is gathered over the sequence before
    its projections (:func:`_whole_seq`)."""
    h = _whole_seq(apply_norm(cfg, x, p.get("ln1s")))
    B, S = x.shape[:2]
    if cfg.mla is not None:
        q, k, v, (c_kv, k_rope) = attn._mla_qkv(cfg, p["attn"], h, pos)
        o = attn._mla_sdpa(cfg, q, k, v)
        a = attn.merge_heads(o, B, S, cfg.n_heads * cfg.mla.v_dim) @ \
            p["attn"]["wo"].to(x.dtype)
        kv = {"c_kv": c_kv, "k_rope": k_rope}
    else:
        q, k, v = attn._qkv(cfg, p["attn"], h, pos)
        o = attn.sdpa(cfg, q, k, v)
        a = attn.merge_heads(o, B, S, cfg.q_dim) @ \
            p["attn"]["wo"].to(x.dtype)
        kv = {"k": k, "v": v}
    x = shard(x + _residual(a), "batch", "act_seq", "embed")
    h = _whole_seq(apply_norm(cfg, x, p.get("ln2s")))
    y, aux = _block_mlp(cfg, p, h, decode=False)
    return shard(x + _residual(y), "batch", "act_seq", "embed"), kv, aux


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
    h = _whole_seq(rmsnorm(x, sp["ln1"]))
    q, k, v = attn._qkv(cfg, sp["attn"], h, pos)
    o = attn.sdpa(cfg, q, k, v)
    B, S = x.shape[:2]
    x = x + _residual(attn.merge_heads(o, B, S, cfg.q_dim) @
                      sp["attn"]["wo"].to(x.dtype))
    x = x + _residual(mlp(cfg, sp["mlp"],
                          _whole_seq(rmsnorm(x, sp["ln2"]))))
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

def build_model(cfg: ModelCfg, device=None, layer_mode: str = "scan"
                ) -> Model:
    """The LM API of ``cfg`` on ``device`` (``None`` = CUDA; ``"meta"``
    builds shapes only).  ``layer_mode`` is the reference's; both modes
    are the port's Python loop over layers."""
    check_ported(cfg)
    if layer_mode not in LAYER_MODES:
        raise ValueError(f"layer_mode={layer_mode!r}; one of {LAYER_MODES}")
    dev = resolve_device(device)
    if cfg.family == "rwkv6":
        return _build_rwkv(cfg, dev)
    if cfg.family == "hybrid":
        return _build_hybrid(cfg, dev)
    return _build_dense(cfg, dev)


def _sharded(fn):
    """``fn`` (a forward, loss, prefill or decode step) as it runs under a
    sharding context: inside
    :func:`~repro_torch.distribution.sharding.plain_as_replicated`."""
    @functools.wraps(fn)
    def run(*args):
        if current_ctx() is None:
            return fn(*args)
        with plain_as_replicated():
            return fn(*args)
    return run


def _api(cfg, dev, init, forward, init_cache, prefill, decode_step, specs,
         cache_specs) -> Model:
    forward = _sharded(forward)
    return Model(cfg, dev, init, forward, _sharded(_loss(forward)),
                 init_cache, _sharded(prefill),
                 _sharded(decode_step), functools.partial(specs, cfg),
                 functools.partial(cache_specs, cfg))


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
    """Layer ``i``'s new state into ``state`` in place: a sharded cache on
    the shards that hold it, each rank its own slice."""
    for k, v in new.items():
        if is_dtensor(state[k]):
            state[k].to_local()[i].copy_(
                to_local_as(v, spec_of(state[k])[1:]))
        else:
            state[k][i].copy_(full(v))


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
    serving runs ``fn`` as it is.  Under a sharding context the recompute
    runs under it too."""
    if cfg.remat == "none":
        return fn

    def contexts():
        fwd, rec = (create_selective_checkpoint_contexts(_keep_dots)
                    if cfg.remat == "dots" else
                    (contextlib.nullcontext(), contextlib.nullcontext()))
        ctx = current_ctx()
        if ctx is None:
            return fwd, rec

        # the recompute runs in the autograd engine's thread, which sees
        # neither this thread's sharding context nor its DTensor switch
        @contextlib.contextmanager
        def recompute():
            with rec, sharding_ctx(ctx), plain_as_replicated():
                yield
        return fwd, recompute()

    def layer(p_l, *args):
        if not wants_grad(*tree_leaves(p_l)):
            return fn(p_l, *args)
        return checkpoint(fn, p_l, *args, use_reentrant=False,
                          context_fn=contexts)
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
                    attn.write_prefix(cache[name][i], t)
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

    return _api(cfg, dev, init, forward, init_cache, prefill, decode_step,
                _dense_specs, _dense_cache_specs)


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

    return _api(cfg, dev, init, forward, init_cache, prefill, decode_step,
                _rwkv_specs, _rwkv_cache_specs)


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
            y, new = m2.mamba2_block(cfg, p_l["m"],
                                     _whole_seq(rmsnorm(x, p_l["ln"])), st)
            x = shard(x + _residual(y), "batch", "act_seq", "embed")
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
            attn.write_prefix(cache["attn_k"][ai], k)
            attn.write_prefix(cache["attn_v"][ai], v)
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

    return _api(cfg, dev, init, forward, init_cache, prefill, decode_step,
                _hybrid_specs, _hybrid_cache_specs)


# ---------------------------------------------------------------------------
# Parameter / cache specs (logical → physical via the active rules)
# ---------------------------------------------------------------------------

_sp = pspec


def _layers(cfg, layer: dict) -> list:
    """One spec dict a layer (the reference's stacked spec without its
    leading ``None``)."""
    return [layer for _ in range(cfg.n_layers)]


def _embed_specs(cfg) -> dict:
    emb = {"tok": _sp("vocab", None)}
    if not cfg.tie_embeddings:
        emb["lm_head"] = _sp(None, "vocab")
    return emb


def _dense_specs(cfg) -> dict:
    attn_specs = (
        {"wq_a": _sp("fsdp", None), "q_a_norm": _sp(None),
         "wq_b": _sp(None, "ff"), "wkv_a": _sp("fsdp", None),
         "kv_a_norm": _sp(None), "wk_b": _sp(None, "ff"),
         "wv_b": _sp(None, "ff"), "wo": _sp("ff", "fsdp")}
        if cfg.mla is not None else
        {k: v for k, v in {
            "wq": _sp("fsdp", "ff"), "wk": _sp("fsdp", "ff"),
            "wv": _sp("fsdp", "ff"), "wo": _sp("ff", "fsdp"),
            "q_norm": _sp(None), "k_norm": _sp(None)}.items()
         if not (k in ("q_norm", "k_norm") and not cfg.qk_norm)})
    if cfg.moe is not None:
        mlp_specs = {"router": _sp(None, None),
                     "w_gate": _sp("expert", "fsdp", "expert_ff"),
                     "w_in": _sp("expert", "fsdp", "expert_ff"),
                     "w_out": _sp("expert", "expert_ff", "fsdp")}
        if cfg.moe.n_shared > 0:
            mlp_specs["shared"] = {"w_gate": _sp("fsdp", "ff"),
                                   "w_in": _sp("fsdp", "ff"),
                                   "w_out": _sp("ff", "fsdp")}
    elif cfg.mlp in ("swiglu", "geglu"):
        mlp_specs = {"w_gate": _sp("fsdp", "ff"), "w_in": _sp("fsdp", "ff"),
                     "w_out": _sp("ff", "fsdp")}
    else:
        mlp_specs = {"w_in": _sp("fsdp", "ff"), "w_out": _sp("ff", "fsdp")}
    layer = {"attn": attn_specs, "mlp": mlp_specs}
    if cfg.norm == "rmsnorm":
        layer["ln1s"] = _sp(None)
        layer["ln2s"] = _sp(None)
    return {"embed": _embed_specs(cfg), "layers": _layers(cfg, layer),
            "final_norm": _sp(None)}


def _kv_ok(cfg) -> bool:
    """Whether the kv heads divide the TP degree (then the cache shards
    them; otherwise its sequence dim)."""
    return (cfg.n_kv_heads % max(axis_size("kv_heads"), 1) == 0
            and axis_size("kv_heads") > 1)


def _dense_cache_specs(cfg, batch=None, max_len=None) -> dict:
    """Decode-cache shardings, divisibility-aware (reference
    ``transformer.py:611-637``): the kv heads when they divide the TP
    degree, else the cache's sequence dim over the model axis (decode
    then runs the seq-sharded flash-decode).  MLA's latent cache has no
    head dim: it always seq-shards.  ``seq_kv`` (the data axis) joins for
    the long-context shapes."""
    if cfg.mla is not None:
        seq = phys("seq_kv", "seq_kv_tp")
        return {"c_kv": Spec(None, *_sp("batch"), seq, None),
                "k_rope": Spec(None, *_sp("batch"), seq, None)}
    if cfg.shard_heads and _kv_ok(cfg):
        seq, kv = phys("seq_kv"), phys("kv_heads")
    else:
        seq, kv = phys("seq_kv", "seq_kv_tp"), None
    b = phys("batch")
    return {"k": Spec(None, b, seq, kv, None),
            "v": Spec(None, b, seq, kv, None)}


def _rwkv_specs(cfg) -> dict:
    tm = {"mu_x": _sp(None), "mu": _sp(None, None),
          "mix_w1": _sp(None, None), "mix_w2": _sp(None, None, None),
          "wr": _sp("fsdp", "ff"), "wk": _sp("fsdp", "ff"),
          "wv": _sp("fsdp", "ff"), "wg": _sp("fsdp", "ff"),
          "wo": _sp("ff", "fsdp"),
          "decay_base": _sp(None), "decay_w1": _sp(None, None),
          "decay_w2": _sp(None, None), "bonus": _sp(None),
          "ln_scale": _sp(None), "ln_bias": _sp(None)}
    cm = {"mu_k": _sp(None), "mu_r": _sp(None),
          "wk": _sp("fsdp", "ff"), "wv": _sp("ff", "fsdp"),
          "wr": _sp("fsdp", "ff")}
    layer = {"tm": tm, "cm": cm, "ln1": _sp(None), "ln2": _sp(None)}
    return {"embed": _embed_specs(cfg), "layers": _layers(cfg, layer),
            "final_norm": _sp(None)}


def _rwkv_cache_specs(cfg, batch=None, max_len=None) -> dict:
    b = phys("batch")
    h = heads_over_model(cfg.d_model // cfg.rwkv.head_size)
    return {"tm_shift": Spec(None, b, None), "cm_shift": Spec(None, b, None),
            "wkv": Spec(None, b, h, None, None)}


def _hybrid_specs(cfg) -> dict:
    m = {"in_proj": _sp("fsdp", "ff"), "conv_w": _sp(None, None),
         "conv_b": _sp(None), "a_log": _sp(None), "d_skip": _sp(None),
         "dt_bias": _sp(None), "norm_scale": _sp(None),
         "out_proj": _sp("ff", "fsdp")}
    shared = {"ln1": _sp(None), "ln2": _sp(None),
              "attn": {"wq": _sp("fsdp", "ff"), "wk": _sp("fsdp", "ff"),
                       "wv": _sp("fsdp", "ff"), "wo": _sp("ff", "fsdp")},
              "mlp": {"w_gate": _sp("fsdp", "ff"),
                      "w_in": _sp("fsdp", "ff"),
                      "w_out": _sp("ff", "fsdp")}}
    return {"embed": _embed_specs(cfg),
            "layers": _layers(cfg, {"m": m, "ln": _sp(None)}),
            "shared": shared, "final_norm": _sp(None)}


def _hybrid_cache_specs(cfg, batch=None, max_len=None) -> dict:
    b = phys("batch")
    kv_ok = _kv_ok(cfg)
    seq = phys("seq_kv") if kv_ok else phys("seq_kv", "seq_kv_tp")
    kv = phys("kv_heads") if kv_ok else None
    h = heads_over_model((cfg.ssm.expand * cfg.d_model) // cfg.ssm.head_dim)
    return {"conv": Spec(None, b, None, None),
            "ssm": Spec(None, b, h, None, None),
            "attn_k": Spec(None, b, seq, kv, None),
            "attn_v": Spec(None, b, seq, kv, None)}
