"""Registry of the ten assigned architectures (+ shapes).

``get(name)`` returns the exact full-size config from the assignment
table; ``get_smoke(name)`` a reduced same-family variant for CPU tests.
"""
from __future__ import annotations

from importlib import import_module

from .shapes import (SHAPES, ShapeCfg, applicable, smoke_shape,  # noqa
                     TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)

_MODULES = {
    "rwkv6-3b": "rwkv6_3b",
    "qwen3-14b": "qwen3_14b",
    "olmo-1b": "olmo_1b",
    "granite-20b": "granite_20b",
    "gemma-2b": "gemma_2b",
    "zamba2-2.7b": "zamba2_2p7b",
    "musicgen-large": "musicgen_large",
    "deepseek-v2-236b": "deepseek_v2_236b",
    "dbrx-132b": "dbrx_132b",
    "chameleon-34b": "chameleon_34b",
}

ARCH_NAMES = tuple(_MODULES)


def _mod(name: str):
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; choose from {ARCH_NAMES}")
    return import_module(f"repro_torch.configs.{_MODULES[name]}")


def get(name: str):
    return _mod(name).full()


def get_smoke(name: str):
    return _mod(name).smoke()
