"""Error-feedback int8 gradient compression for the cross-group all-reduce
(counterpart of ``repro/training/compression.py``).

A ``torch.distributed`` process group takes the place of the reference's
``pod`` mesh axis: each member quantizes ``g + err`` to int8 with a
per-tensor scale, the members agree on the largest scale, all-reduce the
int8 payload (summed in int32) and keep the quantization residual locally
for the next step (error feedback — Karimireddy et al.).  A sharded
leaf (a DTensor on the member's own submesh) is quantized with its whole
tensor's scale and its shard's payload summed with the same shard of the
other members.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.distribution.sharding import full, is_dtensor
from repro_torch.training.tree import tree_map, tree_leaves, unflatten_like


def quantize(x: torch.Tensor):
    """Symmetric per-tensor int8 (round half to even, as ``jnp.round``).
    Returns ``(q, scale)``."""
    xf = x.float()
    scale = torch.clamp(xf.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def ef_compress_sync(grads, err, group=None):
    """Compress, all-reduce and dequantize over ``group`` (``None``: the
    default group).  grads/err: trees of this member's gradient leaves
    (f32 math).  Returns ``(synced_grads_mean, new_err)``."""
    n = dist.get_world_size(group)

    def one(g, e):
        if g.numel() == 0:          # placeholder leaves (e.g. no-op norms)
            return g, e
        x = g.float() + e
        scale = full(quantize(x)[1]).clone()
        # the largest scale across members, so the payloads share a grid
        dist.all_reduce(scale, op=dist.ReduceOp.MAX, group=group)
        q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
        new_e = x - dequantize(q, scale)
        qs = q.to(torch.int32)       # the int8 payload summed in int32
        dist.all_reduce(qs.to_local() if is_dtensor(qs) else qs,
                        op=dist.ReduceOp.SUM, group=group)
        g_sync = qs.float() * scale / n
        return g_sync.to(g.dtype), new_e

    out = [one(g, e) for g, e in zip(tree_leaves(grads), tree_leaves(err))]
    return (unflatten_like(grads, [o[0] for o in out]),
            unflatten_like(grads, [o[1] for o in out]))


def init_error_feedback(params):
    return tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                    params)
