"""musicgen-large — decoder-only over EnCodec tokens [arXiv:2306.05284].

Modality frontend is a STUB: input_specs() provides precomputed EnCodec
frame token ids (vocab 2048); the backbone below is the transformer.
"""
import dataclasses

from repro_torch.models.common import ModelCfg


def full() -> ModelCfg:
    return ModelCfg(
        name="musicgen-large", family="dense",
        n_layers=48, d_model=2048, n_heads=32, n_kv_heads=32, head_dim=64,
        d_ff=8192, vocab=2048, mlp="gelu", pos="sinusoidal",
        frontend="audio_tokens",
    )


def smoke() -> ModelCfg:
    return dataclasses.replace(
        full(), n_layers=2, d_model=128, n_heads=4, n_kv_heads=4,
        head_dim=32, d_ff=256, vocab=128, remat="none")
