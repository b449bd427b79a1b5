"""Mixture-of-Experts: the router and the dropless dense path.

Counterpart of ``repro/models/moe.py``:

* ``moe_dense`` — every (token, expert) pair is computed and masked by
  the combine weights: exact, dropless.  The reference uses it for
  decode, for token counts below ``4 × n_experts`` and as the oracle of
  its expert-parallel path.
* ``moe_ep`` — the reference's capacity-bounded, sort-based dispatch with
  ``all_to_all`` runs only under a sharding context; without one the
  reference returns ``moe_dense`` (``moe.py:133-135``).  The port has no
  sharding context, so ``moe_ep`` is ``moe_dense`` here too, and the
  capacity-bounded dispatch is not ported.
* shared experts (DeepSeek-V2) are a plain dense MLP added to the output.

Router losses: the Switch load-balance aux (``E·Σ f_e·P_e``) and the
z-loss, summed.  The router runs in f32 on an f32 copy of the tokens.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

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
    g = x @ sp["w_gate"].to(dt)
    h = x @ sp["w_in"].to(dt)
    return _act(cfg, g, h) @ sp["w_out"].to(dt)


def moe_dense(cfg, p, x: torch.Tensor):
    """x: ``[B, S, D]`` → (y ``[B, S, D]``, aux).  Every expert computed
    for every token, then the masked combine: the combine weights
    ``[T, E]`` hold each token's renormalised gates at its top-k experts
    and zeros elsewhere."""
    B, S, D = x.shape
    e = cfg.moe
    dt = x.dtype
    xf = x.reshape(B * S, D)
    gates, idx, aux = _router(cfg, p, xf)
    comb = torch.zeros((B * S, e.n_experts), dtype=dt, device=x.device)
    comb.scatter_add_(1, idx, gates)
    # "td,edf->etf" as a batched product over experts with the tokens
    # broadcast (stride 0): torch's einsum would first copy each [E, D, F]
    # weight into a [D, E·F] layout, on every call
    xe = xf.expand(e.n_experts, B * S, D)
    g = torch.bmm(xe, p["w_gate"].to(dt))
    h = torch.bmm(xe, p["w_in"].to(dt))
    hh = _act(cfg, g, h) * comb.T[:, :, None]
    y = torch.einsum("etf,efd->td", hh, p["w_out"].to(dt)).reshape(B, S, D)
    if e.n_shared > 0:
        y = y + _shared_mlp(cfg, p, x)
    return y, aux


def moe_ep(cfg, p, x: torch.Tensor):
    """The reference's expert-parallel path without a sharding context:
    the dense path (``moe.py:133-135``)."""
    return moe_dense(cfg, p, x)


def moe(cfg, p, x: torch.Tensor, *, decode: bool = False):
    """Dispatch as the reference does: the dense path for decode and for
    fewer than ``4 × n_experts`` tokens, the expert-parallel one
    otherwise."""
    if decode or x.shape[0] * x.shape[1] < 4 * cfg.moe.n_experts:
        return moe_dense(cfg, p, x)
    return moe_ep(cfg, p, x)
