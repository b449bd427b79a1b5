"""gemma-2b — GeGLU, head_dim=256, MQA [arXiv:2403.08295]."""
import dataclasses

from repro_torch.models.common import ModelCfg


def full() -> ModelCfg:
    return ModelCfg(
        name="gemma-2b", family="dense",
        n_layers=18, d_model=2048, n_heads=8, n_kv_heads=1, head_dim=256,
        d_ff=16384, vocab=256000, mlp="geglu", tie_embeddings=True,
        # 8 heads < 16-way TP: attention replicated over the model axis;
        # the param mass is in vocab (524M) + GeGLU ff — both TP-sharded.
        shard_heads=False,
    )


def smoke() -> ModelCfg:
    return dataclasses.replace(
        full(), n_layers=2, d_model=128, n_heads=2, n_kv_heads=1,
        head_dim=64, d_ff=512, vocab=512, remat="none")
