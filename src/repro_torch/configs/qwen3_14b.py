"""qwen3-14b — dense GQA with per-head qk RMSNorm [hf:Qwen/Qwen3-8B]."""
import dataclasses

from repro_torch.models.common import ModelCfg


def full() -> ModelCfg:
    return ModelCfg(
        name="qwen3-14b", family="dense",
        n_layers=40, d_model=5120, n_heads=40, n_kv_heads=8, head_dim=128,
        d_ff=17408, vocab=151936, qk_norm=True, rope_theta=1e6,
        fsdp=True,
        # 8 kv heads < 16-way TP → kv replicated, q heads sharded (uneven)
        shard_heads=True,
    )


def smoke() -> ModelCfg:
    return dataclasses.replace(
        full(), n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
        head_dim=32, d_ff=256, vocab=512, fsdp=False, remat="none")
