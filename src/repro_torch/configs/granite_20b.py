"""granite-20b — code model, MQA (kv=1) [arXiv:2405.04324].

d_ff = 4·d_model with a 2-matrix GELU MLP (gpt-bigcode style — this is
what lands the advertised 20B total); attention follows the assignment
(48 heads, single KV head, rope).
"""
import dataclasses

from repro_torch.models.common import ModelCfg


def full() -> ModelCfg:
    return ModelCfg(
        name="granite-20b", family="dense",
        n_layers=52, d_model=6144, n_heads=48, n_kv_heads=1, head_dim=128,
        d_ff=24576, vocab=49152, mlp="gelu", fsdp=True,
    )


def smoke() -> ModelCfg:
    return dataclasses.replace(
        full(), n_layers=2, d_model=128, n_heads=4, n_kv_heads=1,
        head_dim=32, d_ff=256, vocab=512, fsdp=False, remat="none")
