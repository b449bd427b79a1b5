"""deepseek-v2-236b — MLA (kv_lora=512), 2 shared + 160 routed top-6 MoE
[arXiv:2405.04434].

Deviation noted in DESIGN.md: the real model's layer 0 uses a dense FFN;
we keep a uniform MoE stack so the depth dimension scans.
"""
import dataclasses

from repro_torch.models.common import MLACfg, ModelCfg, MoECfg


def full() -> ModelCfg:
    return ModelCfg(
        name="deepseek-v2-236b", family="moe",
        n_layers=60, d_model=5120, n_heads=128, n_kv_heads=128,
        head_dim=192,                      # qk_nope + qk_rope (informational)
        d_ff=1536, vocab=102400, rope_theta=1e4,
        moe=MoECfg(n_experts=160, top_k=6, d_ff_expert=1536, n_shared=2),
        mla=MLACfg(q_lora=1536, kv_lora=512, qk_nope=128, qk_rope=64,
                   v_dim=128),
        fsdp=True,
        # pure-bf16 params + fp32 moments: the 16 GB/chip budget at this
        # scale (see EXPERIMENTS.md memory analysis)
        param_dtype="bfloat16",
    )


def smoke() -> ModelCfg:
    return dataclasses.replace(
        full(), n_layers=2, d_model=128, n_heads=4, n_kv_heads=4,
        head_dim=48, d_ff=64, vocab=512,
        moe=MoECfg(n_experts=8, top_k=2, d_ff_expert=64, n_shared=1),
        mla=MLACfg(q_lora=64, kv_lora=32, qk_nope=32, qk_rope=16,
                   v_dim=32),
        fsdp=False, remat="none")
