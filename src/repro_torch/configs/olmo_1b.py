"""olmo-1b — dense, non-parametric LayerNorm [arXiv:2402.00838]."""
import dataclasses

from repro_torch.models.common import ModelCfg


def full() -> ModelCfg:
    return ModelCfg(
        name="olmo-1b", family="dense",
        n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
        d_ff=8192, vocab=50304, norm="layernorm_np", tie_embeddings=True,
    )


def smoke() -> ModelCfg:
    return dataclasses.replace(
        full(), n_layers=2, d_model=128, n_heads=4, n_kv_heads=4,
        head_dim=32, d_ff=256, vocab=512, remat="none")
