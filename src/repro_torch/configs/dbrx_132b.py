"""dbrx-132b — 16 experts top-4 fine-grained MoE [hf:databricks/dbrx-base]."""
import dataclasses

from repro_torch.models.common import ModelCfg, MoECfg


def full() -> ModelCfg:
    return ModelCfg(
        name="dbrx-132b", family="moe",
        n_layers=40, d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
        d_ff=10752, vocab=100352, rope_theta=5e5,
        moe=MoECfg(n_experts=16, top_k=4, d_ff_expert=10752),
        fsdp=True,
        # pure-bf16 params + fp32 moments: the 16 GB/chip budget at this
        # scale (see EXPERIMENTS.md memory analysis)
        param_dtype="bfloat16",
    )


def smoke() -> ModelCfg:
    return dataclasses.replace(
        full(), n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
        head_dim=32, d_ff=128, vocab=512,
        moe=MoECfg(n_experts=4, top_k=2, d_ff_expert=128),
        fsdp=False, remat="none")
