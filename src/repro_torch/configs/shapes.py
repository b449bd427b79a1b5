"""Assigned input shapes (LM-family: seq_len × global_batch).

``decode_*`` / ``long_*`` lower ``serve_step`` (one new token against a
KV cache / recurrent state of ``seq_len``), not ``train_step``.
``long_500k`` requires sub-quadratic attention state and is run only for
the SSM/hybrid archs (rwkv6-3b, zamba2-2.7b) — skipped for pure
full-attention archs, per the assignment (see DESIGN.md §Shape-skips).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ShapeCfg:
    name: str
    seq_len: int
    global_batch: int
    kind: str                  # "train" | "prefill" | "decode"


TRAIN_4K = ShapeCfg("train_4k", 4_096, 256, "train")
PREFILL_32K = ShapeCfg("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = ShapeCfg("decode_32k", 32_768, 128, "decode")
LONG_500K = ShapeCfg("long_500k", 524_288, 1, "decode")

SHAPES = {s.name: s for s in
          (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}

# families with O(1)-in-seq decode state → long_500k is runnable
_SUBQUADRATIC = ("rwkv6", "hybrid")


def applicable(cfg, shape: ShapeCfg) -> tuple[bool, str]:
    """(runnable?, reason).  All 10 archs are decoder LMs → decode OK."""
    if shape.name == "long_500k" and cfg.family not in _SUBQUADRATIC:
        return False, ("full-attention arch: a 500k dense KV cache per "
                       "token is outside this shape's regime (assignment: "
                       "run for SSM/hybrid/linear-attn only)")
    return True, ""


def smoke_shape(shape: ShapeCfg) -> ShapeCfg:
    """Reduced version of a shape for CPU smoke tests."""
    return ShapeCfg(shape.name + "-smoke",
                    seq_len=min(shape.seq_len, 64),
                    global_batch=min(shape.global_batch, 2),
                    kind=shape.kind)
