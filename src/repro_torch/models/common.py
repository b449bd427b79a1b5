"""Model configuration schema covering the ten assigned architectures.

Counterpart of ``repro/models/common.py``, ported whole so that every
config module carries across unchanged: one frozen dataclass per concern,
``ModelCfg`` composes them.  ``act_dtype`` and ``p_dtype`` are torch
dtypes.  Fields that only the reference's sharding or roofline passes read
(``fsdp``, ``shard_heads``, ``flash_decode``, ``gqa_pad``, ``remat``,
``attn_chunk``) are kept as data.
"""
from __future__ import annotations

import dataclasses
from typing import Literal

import torch


_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


@dataclasses.dataclass(frozen=True)
class MoECfg:
    n_experts: int            # routed experts
    top_k: int
    d_ff_expert: int          # per-expert hidden dim
    n_shared: int = 0         # always-on shared experts (deepseek-v2: 2)
    capacity_factor: float = 1.25
    router_z_coef: float = 1e-3   # router z-loss (stability)
    aux_coef: float = 1e-2        # load-balance aux loss


@dataclasses.dataclass(frozen=True)
class MLACfg:
    q_lora: int = 1536        # low-rank q down-projection
    kv_lora: int = 512        # compressed kv latent (the cached tensor)
    qk_nope: int = 128        # non-rotary per-head q/k dim
    qk_rope: int = 64         # rotary per-head dim (shared k_rope)
    v_dim: int = 128          # per-head value dim


@dataclasses.dataclass(frozen=True)
class SSMCfg:
    """Mamba2 (SSD) block configuration (zamba2)."""
    d_state: int = 64
    expand: int = 2
    head_dim: int = 64        # SSD head size (d_inner / n_heads)
    conv_width: int = 4
    chunk: int = 128          # SSD chunked-scan block length


@dataclasses.dataclass(frozen=True)
class RWKVCfg:
    head_size: int = 64       # per-head k/v channel count
    decay_lora: int = 64      # low-rank data-dependent decay (w) dim
    mix_lora: int = 32        # low-rank token-shift mixing dim
    ff_mult: float = 3.5      # channel-mix hidden = ff_mult * d_model
    chunk: int = 32           # WKV chunked-scan block length


@dataclasses.dataclass(frozen=True)
class ModelCfg:
    name: str
    family: Literal["dense", "moe", "rwkv6", "hybrid"]
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    # -- variations ---------------------------------------------------------
    norm: Literal["rmsnorm", "layernorm_np"] = "rmsnorm"
    mlp: Literal["swiglu", "geglu", "gelu"] = "swiglu"
    qk_norm: bool = False
    pos: Literal["rope", "sinusoidal", "none"] = "rope"
    rope_theta: float = 1e4
    tie_embeddings: bool = False
    logit_softcap: float = 0.0        # gemma-style tanh soft-capping (0=off)
    moe: MoECfg | None = None
    mla: MLACfg | None = None
    ssm: SSMCfg | None = None
    rwkv: RWKVCfg | None = None
    hybrid_attn_every: int = 0        # zamba2: shared attn block period
    # -- numerics / impl ----------------------------------------------------
    dtype: str = "bfloat16"           # activation/compute dtype
    param_dtype: str = "float32"
    attn_impl: Literal["xla_chunked", "xla_unrolled", "naive",
                       "pallas"] = "xla_chunked"
    attn_chunk: int = 512             # KV block for chunked attention
    remat: Literal["none", "full", "dots"] = "full"
    # -- sharding hints (read by launch.mesh.make_ctx and the models) --------
    fsdp: bool = False                # ZeRO-3 param sharding over data axis
    shard_heads: bool = True          # False when heads % TP != 0 everywhere
    # perf toggles (True = optimized path; False reproduces the baseline
    # lowering for the §Perf before/after attribution)
    flash_decode: bool = True         # seq-sharded partial-softmax decode
    gqa_pad: bool = True              # head pad/KV-rep when H % TP != 0
    # -- modality stub ------------------------------------------------------
    frontend: Literal["text", "audio_tokens", "vq_image_tokens"] = "text"

    # -- derived ------------------------------------------------------------
    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    @property
    def act_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]

    @property
    def p_dtype(self) -> torch.dtype:
        return _DTYPES[self.param_dtype]

    def n_params(self) -> int:
        """Exact parameter count (used for 6·N·D roofline bookkeeping)."""
        D, F, V, L = self.d_model, self.d_ff, self.vocab, self.n_layers
        emb = V * D * (1 if self.tie_embeddings else 2)
        if self.family == "rwkv6":
            r = self.rwkv
            H = self.d_model // r.head_size
            tm = (D * D * 4                      # r,k,v,g (square for rwkv6)
                  + D * D                        # output
                  + 2 * (D * r.decay_lora)       # w lora
                  + 5 * (D * r.mix_lora) * 2     # ddlerp loras (x5 targets)
                  + 6 * D + H * r.head_size)     # mix biases, decay, bonus
            cm = D * int(r.ff_mult * D) * 2 + 2 * D
            per_layer = tm + cm + 2 * D
            return emb + L * per_layer + D
        per_attn = (D * self.q_dim + 2 * D * self.kv_dim
                    + self.q_dim * D)
        if self.mla is not None:
            m = self.mla
            qk = m.qk_nope + m.qk_rope
            per_attn = (D * m.q_lora + m.q_lora * self.n_heads * qk
                        + D * (m.kv_lora + m.qk_rope)
                        + m.kv_lora * self.n_heads * (m.qk_nope + m.v_dim)
                        + self.n_heads * m.v_dim * D)
        n_mats = 3 if self.mlp in ("swiglu", "geglu") else 2
        per_mlp = n_mats * D * F
        if self.moe is not None:
            e = self.moe
            per_mlp = (D * e.n_experts                       # router
                       + n_mats * D * e.d_ff_expert
                       * (e.n_experts + e.n_shared))
        if self.family == "hybrid":
            s = self.ssm
            d_in = s.expand * D
            nh = d_in // s.head_dim
            per_ssm = (D * (2 * d_in + 2 * s.d_state + nh)   # in_proj
                       + s.conv_width * (d_in + 2 * s.d_state)
                       + d_in * D + nh + nh + d_in)          # out, A, D, norm
            per_mlp = n_mats * D * F
            attn_layers = (self.n_layers // self.hybrid_attn_every
                           if self.hybrid_attn_every else 0)
            # shared attn+mlp block counted once (zamba2's trick)
            shared = per_attn + per_mlp + 2 * D
            return emb + L * (per_ssm + 2 * D) + shared + D \
                + attn_layers * 0
        per_norm = 2 * D if self.norm == "rmsnorm" else 0
        return emb + L * (per_attn + per_mlp + per_norm) + \
            (D if self.norm == "rmsnorm" else 0)

    def active_params(self) -> int:
        """Active params per token (MoE: shared + top_k experts only)."""
        if self.moe is None:
            return self.n_params()
        e = self.moe
        n_mats = 3 if self.mlp in ("swiglu", "geglu") else 2
        full_moe = n_mats * self.d_model * e.d_ff_expert * \
            (e.n_experts + e.n_shared) * self.n_layers
        act_moe = n_mats * self.d_model * e.d_ff_expert * \
            (e.top_k + e.n_shared) * self.n_layers
        return self.n_params() - full_moe + act_moe
