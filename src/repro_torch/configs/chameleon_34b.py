"""chameleon-34b — early-fusion VQ image tokens [arXiv:2405.09818].

Modality frontend is a STUB: input_specs() provides precomputed VQ image
token ids inside the unified 65536 vocabulary; the backbone is a llama-
style decoder with qk-norm (chameleon's divergence fix).
"""
import dataclasses

from repro_torch.models.common import ModelCfg


def full() -> ModelCfg:
    return ModelCfg(
        name="chameleon-34b", family="dense",
        n_layers=48, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
        d_ff=22016, vocab=65536, qk_norm=True, fsdp=True,
        frontend="vq_image_tokens",
    )


def smoke() -> ModelCfg:
    return dataclasses.replace(
        full(), n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
        head_dim=32, d_ff=256, vocab=512, fsdp=False, remat="none")
