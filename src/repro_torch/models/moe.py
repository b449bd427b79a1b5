"""Mixture-of-Experts: the router and the dropless dense path.

Counterpart of ``repro/models/moe.py``:

* ``moe_dense`` — every (token, expert) pair is computed and masked by
  the combine weights: exact, dropless.  The reference uses it for
  decode, for token counts below ``4 × n_experts`` and as the oracle of
  its expert-parallel path.
* ``moe_ep`` — the expert-parallel path for many-token steps under a
  sharding context: each rank routes its (batch, sequence) shard, sorts
  the token-expert pairs by expert (stable), fills ``_capacity`` slots an
  expert, sends each expert's slots to the rank that owns it with an
  ``all_to_all_single`` over the ``model`` group and back after the
  expert products (the expert weights all-gathered over the data group
  first under ``fsdp``).  Without a context, or when ``S % M`` or
  ``E % M`` is not 0, it is ``moe_dense``, as in the reference
  (``moe.py:133-142``).
* shared experts (DeepSeek-V2) are a plain dense MLP added to the output.

Router losses: the Switch load-balance aux (``E·Σ f_e·P_e``) and the
z-loss, summed.  The router runs in f32 on an f32 copy of the tokens.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist
import torch.distributed.nn.functional as dnn
import torch.nn.functional as F

from repro_torch.distribution.sharding import (current_ctx, from_local_as,
                                               mesh_axes, shard, to_local_as)
from repro_torch.models.layers import dense_init


def init_moe(gen: torch.Generator, cfg) -> dict:
    e, D = cfg.moe, cfg.d_model
    Fe = e.d_ff_expert
    dt = cfg.p_dtype
    p = {
        "router": dense_init(gen, (D, e.n_experts), dt),
        "w_gate": dense_init(gen, (e.n_experts, D, Fe), dt),
        "w_in": dense_init(gen, (e.n_experts, D, Fe), dt),
        "w_out": dense_init(gen, (e.n_experts, Fe, D), dt),
    }
    if e.n_shared > 0:
        Fs = e.n_shared * Fe
        p["shared"] = {"w_gate": dense_init(gen, (D, Fs), dt),
                       "w_in": dense_init(gen, (D, Fs), dt),
                       "w_out": dense_init(gen, (Fs, D), dt)}
    return p


def _act(cfg, g: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    a = F.silu(g) if cfg.mlp != "geglu" else F.gelu(g, approximate="tanh")
    return a * h


def _router(cfg, p, xf: torch.Tensor):
    """xf: ``[T, D]`` → gates ``[T, k]`` (xf's dtype), idx ``[T, k]``
    int64, and the aux loss plus the z-loss (an f32 scalar)."""
    e = cfg.moe
    logits = xf.float() @ p["router"].float()
    probs = torch.softmax(logits, dim=-1)
    gates, idx = torch.topk(probs, e.top_k, dim=-1)
    gates = gates / gates.sum(dim=-1, keepdim=True).clamp_min(1e-9)
    # load-balance aux: fraction routed vs mean prob (Switch eq. 4-6)
    one_hot = F.one_hot(idx, e.n_experts).float()
    f = one_hot.sum(dim=(0, 1)) / (xf.shape[0] * e.top_k)
    aux = e.n_experts * (f * probs.mean(dim=0)).sum() * e.aux_coef
    z = torch.logsumexp(logits, dim=-1).square().mean() * e.router_z_coef
    return gates.to(xf.dtype), idx, aux + z


def _shared_mlp(cfg, p, x: torch.Tensor) -> torch.Tensor:
    dt = x.dtype
    sp = p["shared"]
    g = shard(x @ sp["w_gate"].to(dt), "batch", "seq", "ff")
    h = shard(x @ sp["w_in"].to(dt), "batch", "seq", "ff")
    return _act(cfg, g, h) @ sp["w_out"].to(dt)


def _experts_dense(cfg, p, xf, gates, idx, lo: int = 0):
    """The masked combine of experts ``lo .. lo + E_l`` (the experts of
    ``p``'s weights) over every token of ``xf`` ``[T, D]``."""
    T, D = xf.shape
    dt = xf.dtype
    E_l = p["w_gate"].shape[0]
    comb = torch.zeros((T, cfg.moe.n_experts), dtype=dt, device=xf.device)
    comb.scatter_add_(1, idx, gates)
    # "td,edf->etf" as a batched product over experts with the tokens
    # broadcast (stride 0): torch's einsum would first copy each [E, D, F]
    # weight into a [D, E·F] layout, on every call
    xe = xf.expand(E_l, T, D)
    g = torch.bmm(xe, p["w_gate"].to(dt))
    h = torch.bmm(xe, p["w_in"].to(dt))
    hh = _act(cfg, g, h) * comb.T[lo:lo + E_l, :, None]
    return torch.einsum("etf,efd->td", hh, p["w_out"].to(dt))


def moe_dense(cfg, p, x: torch.Tensor):
    """x: ``[B, S, D]`` → (y ``[B, S, D]``, aux).  Every expert computed
    for every token, then the masked combine: the combine weights
    ``[T, E]`` hold each token's renormalised gates at its top-k experts
    and zeros elsewhere.  Under a sharding context (decode and short
    steps) it is a manual region: every rank routes all the tokens (the
    router losses exact), computes its own experts' share (the experts
    over ``model``) and the shares are summed over the ``model`` group."""
    B, S, D = x.shape
    e = cfg.moe
    ctx = current_ctx()
    if ctx is None:
        xf = x.reshape(B * S, D)
        gates, idx, aux = _router(cfg, p, xf)
        y = _experts_dense(cfg, p, xf, gates, idx).reshape(B, S, D)
    else:
        tp = ctx.tp_axis
        M = mesh_axes(ctx.mesh)[tp]
        ep = tp if e.n_experts % M == 0 else None
        # with the experts split, each rank's gradient of the tokens and
        # the router is its experts' share (and 1 / M of the aux's)
        work = (ep,)
        xf = to_local_as(x, (None, None, None), work).reshape(B * S, D)
        gates, idx, aux = _router(
            cfg, {"router": to_local_as(p["router"], (None, None), work)},
            xf)
        wl = {k: to_local_as(p[k], (ep, None, None))
              for k in ("w_gate", "w_in", "w_out")}
        lo = (ctx.mesh.get_local_rank(tp) * (e.n_experts // M) if ep
              else 0)
        y = _experts_dense(cfg, wl, xf, gates, idx, lo)
        if ep:
            group = ctx.mesh.get_group(tp)
            y = _SumShares.apply(y, group)
            aux = _RankMean.apply(aux, (group,))
        y = from_local_as(y.reshape(B, S, D), (None, None, None))
        aux = from_local_as(aux, ())
    if e.n_shared > 0:
        y = y + _shared_mlp(cfg, p, x)
    return shard(y, "batch", "seq", "embed"), aux


def _capacity(t_local: int, cfg) -> int:
    e = cfg.moe
    c = int(math.ceil(t_local * e.top_k / e.n_experts * e.capacity_factor))
    return max(8, -(-c // 8) * 8)  # round up to a multiple of 8


class _AllGather(torch.autograd.Function):
    """The shards of ``group`` concatenated along ``dim``; the backward
    sums each shard's gradient over the group back to its owner (a
    reduce-scatter).  torch's ``distributed.nn`` all-gather takes its
    backward's group ranks for global ranks over gloo, which fails on any
    group but the world."""

    @staticmethod
    def forward(ctx, w, group, dim):
        ctx.group, ctx.dim = group, dim
        n = dist.get_world_size(group)
        w0 = w.movedim(dim, 0).contiguous()
        out = w0.new_empty((n * w0.shape[0], *w0.shape[1:]))
        dist.all_gather_into_tensor(out, w0, group=group)
        return out.movedim(0, dim)

    @staticmethod
    def backward(ctx, g):
        n = dist.get_world_size(ctx.group)
        g0 = g.movedim(ctx.dim, 0).contiguous()
        out = g0.new_empty((g0.shape[0] // n, *g0.shape[1:]))
        dist.reduce_scatter_tensor(out, g0, group=ctx.group)
        return out.movedim(0, ctx.dim), None, None


def _gather(w, axis: str, dim: int):
    """The FSDP all-gather of an expert weight's shards over ``axis``
    along ``dim`` (differentiable; ``w`` itself on an axis of size 1)."""
    group = current_ctx().mesh.get_group(axis)
    if dist.get_world_size(group) == 1:
        return w
    return _AllGather.apply(w, group, dim)


def _all_to_all(x, group):
    """``x`` ``[M·n, ...]`` split in M blocks, block j sent to rank j of
    ``group``; the blocks received, in rank order (differentiable)."""
    return dnn.all_to_all_single(torch.empty_like(x), x.contiguous(),
                                 group=group)


class _SumShares(torch.autograd.Function):
    """The sum over ``group`` of each rank's share of a value.  The sum
    leaves the region replicated, so each share's gradient is the
    replicated cotangent itself: the backward sends nothing (an all-reduce
    there would count it once a rank)."""

    @staticmethod
    def forward(ctx, t, group):
        t = t.clone()
        dist.all_reduce(t, group=group)
        return t

    @staticmethod
    def backward(ctx, g):
        return g, None


class _RankMean(torch.autograd.Function):
    """The mean over ``groups`` of a value each rank holds (the
    reference's ``pmean``).  It leaves the region replicated, so each
    rank's value takes ``1 / n`` of the replicated cotangent, with no
    collective."""

    @staticmethod
    def forward(ctx, t, groups):
        t = t.clone()
        ctx.n = 1
        for g in groups:
            dist.all_reduce(t, group=g)
            ctx.n *= dist.get_world_size(g)
        return t / ctx.n

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None


def moe_ep_local(cfg, p, xl, M: int, group, aux_groups=()):
    """The expert-parallel MoE on one rank: ``xl`` ``[B_l, S_l, D]`` its
    token shard; ``p``'s expert weights its ``E / M`` experts (whole over
    ``fsdp``); ``group`` the ``M`` ranks of the model axis.  Returns
    (y ``[B_l, S_l, D]``, aux): aux is the local router loss averaged over
    ``aux_groups`` (the token shards' axes), as the reference's
    ``pmean``."""
    e = cfg.moe
    Bl, Sl, D = xl.shape
    T = Bl * Sl
    xf = xl.reshape(T, D)
    gates, idx, aux = _router(cfg, p, xf)
    if aux_groups:
        aux = _RankMean.apply(aux, tuple(aux_groups))
    C = _capacity(T, cfg)
    A = T * e.top_k
    e_flat = idx.reshape(A)
    t_flat = torch.arange(T, device=xl.device).repeat_interleave(e.top_k)
    g_flat = gates.reshape(A)
    order = torch.argsort(e_flat, stable=True)
    e_s, t_s, g_s = e_flat[order], t_flat[order], g_flat[order]
    starts = torch.searchsorted(e_s, torch.arange(e.n_experts,
                                                  device=xl.device))
    pos = torch.arange(A, device=xl.device) - starts[e_s]
    keep = pos < C
    pos_c = torch.where(keep, pos, 0)
    src = torch.where(keep[:, None], xf[t_s], 0)
    buf = torch.zeros((e.n_experts, C, D), dtype=xl.dtype, device=xl.device)
    buf = buf.index_put((e_s, pos_c), src, accumulate=True)
    E_l = e.n_experts // M
    # dispatch: every rank sends C slots of each expert to its owner
    recv = _all_to_all(buf, group)                    # [M·E_l, C, D]
    recv = recv.reshape(M, E_l, C, D).transpose(0, 1).reshape(E_l, M * C, D)
    dt = xl.dtype
    g1 = torch.bmm(recv, p["w_gate"].to(dt))
    h1 = torch.bmm(recv, p["w_in"].to(dt))
    y = torch.bmm(_act(cfg, g1, h1), p["w_out"].to(dt))   # [E_l, M·C, D]
    y = y.reshape(E_l, M, C, D).transpose(0, 1).reshape(M * E_l, C, D)
    back = _all_to_all(y, group)                      # [E, C, D]
    contrib = back[e_s, pos_c] * keep[:, None]
    out = torch.zeros((T, D), dtype=dt, device=xl.device)
    out = out.index_add(0, t_s, g_s[:, None] * contrib)
    return out.reshape(Bl, Sl, D), aux


def moe_ep(cfg, p, x: torch.Tensor):
    """Expert-parallel MoE for many-token steps (train / prefill), under a
    sharding context: a manual region over (batch → data axes, seq →
    ``model``) with the experts over ``model`` (reference
    ``moe.py:128-199``).  Falls back to the dense oracle otherwise."""
    ctx = current_ctx()
    if ctx is None:
        return moe_dense(cfg, p, x)
    B, S, D = x.shape
    e = cfg.moe
    tp = ctx.tp_axis
    M = mesh_axes(ctx.mesh)[tp]
    if S % M != 0 or e.n_experts % M != 0:
        return moe_dense(cfg, p, x)
    dp = ctx.rules.get("batch")
    fsdp = ctx.rules.get("fsdp")
    x_spec = (dp, tp, None)
    xl = to_local_as(x, x_spec)
    # the router and the experts are used whole on each rank's tokens:
    # their gradients leave the region as partial sums over the token axes
    wl = {"router": to_local_as(p["router"], (None, None), x_spec),
          "w_gate": to_local_as(p["w_gate"], (tp, fsdp, None), x_spec),
          "w_in": to_local_as(p["w_in"], (tp, fsdp, None), x_spec),
          "w_out": to_local_as(p["w_out"], (tp, None, fsdp), x_spec)}
    if fsdp is not None:      # FSDP: gather the layer's weights before use
        wl["w_gate"] = _gather(wl["w_gate"], fsdp, 1)
        wl["w_in"] = _gather(wl["w_in"], fsdp, 1)
        wl["w_out"] = _gather(wl["w_out"], fsdp, 2)
    axes = (dp if isinstance(dp, tuple) else (dp,) if dp else ()) + (tp,)
    yl, aux = moe_ep_local(cfg, wl, xl, M, ctx.mesh.get_group(tp),
                           [ctx.mesh.get_group(a) for a in axes])
    # the tokens back in the residual's layout before the shared experts
    # join: the gradient of their product then comes back with the
    # sequence whole (torch 2.11's DTensor cannot flatten a split one)
    y = shard(from_local_as(yl, x_spec), "batch", "seq", "embed")
    if e.n_shared > 0:
        y = y + _shared_mlp(cfg, p, x)
    return shard(y, "batch", "seq", "embed"), from_local_as(aux, ())


def moe(cfg, p, x: torch.Tensor, *, decode: bool = False):
    """Dispatch as the reference does: the dense path for decode and for
    fewer than ``4 × n_experts`` tokens, the expert-parallel one
    otherwise."""
    if decode or x.shape[0] * x.shape[1] < 4 * cfg.moe.n_experts:
        return moe_dense(cfg, p, x)
    return moe_ep(cfg, p, x)
