"""rwkv6-3b — Finch: attention-free, data-dependent decay [arXiv:2404.05892]."""
import dataclasses

from repro_torch.models.common import ModelCfg, RWKVCfg


def full() -> ModelCfg:
    return ModelCfg(
        name="rwkv6-3b", family="rwkv6",
        n_layers=32, d_model=2560, n_heads=40, n_kv_heads=40, head_dim=64,
        d_ff=8960, vocab=65536, pos="none",
        rwkv=RWKVCfg(head_size=64, decay_lora=64, mix_lora=32, ff_mult=3.5),
    )


def smoke() -> ModelCfg:
    return dataclasses.replace(
        full(), n_layers=2, d_model=128, n_heads=2, n_kv_heads=2,
        d_ff=448, vocab=512,
        rwkv=RWKVCfg(head_size=64, decay_lora=8, mix_lora=4, ff_mult=3.5),
        remat="none")
