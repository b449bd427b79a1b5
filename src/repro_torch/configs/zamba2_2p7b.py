"""zamba2-2.7b — Mamba2 backbone + shared attention blocks [arXiv:2411.15242]."""
import dataclasses

from repro_torch.models.common import ModelCfg, SSMCfg


def full() -> ModelCfg:
    return ModelCfg(
        name="zamba2-2.7b", family="hybrid",
        n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32, head_dim=80,
        d_ff=10240, vocab=32000,
        ssm=SSMCfg(d_state=64, expand=2, head_dim=64, conv_width=4,
                   chunk=128),
        hybrid_attn_every=6,
    )


def smoke() -> ModelCfg:
    return dataclasses.replace(
        full(), n_layers=4, d_model=128, n_heads=4, n_kv_heads=4,
        head_dim=32, d_ff=256, vocab=512,
        ssm=SSMCfg(d_state=16, expand=2, head_dim=32, conv_width=4,
                   chunk=16),
        hybrid_attn_every=2, remat="none")
