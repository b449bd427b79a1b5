"""Stand-ins for every model input, with no allocation (counterpart of
``repro/launch/specs.py``).

The reference's ``ShapeDtypeStruct``s are tensors on the ``meta`` device
here: the model is built there, so its parameters and caches have shapes
and dtypes and no storage.  ``input_specs(model, shape_cfg)`` returns
(args, specs) for the step the shape lowers: the train step for train
shapes, ``prefill`` for prefill shapes, ``decode_step`` for decode
shapes.  For the ``[audio]`` / ``[vlm]`` archs the modality frontend is a
stub: these stand-ins ARE the precomputed frame/patch token ids.
"""
from __future__ import annotations

import torch

from repro_torch.distribution.sharding import pspec
from repro_torch.models.layers import META
from repro_torch.models.transformer import Model, build_model


def _meta_model(model: Model) -> Model:
    return model if model.device.type == "meta" else \
        build_model(model.cfg, "meta")


def _sds(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def param_shapes(model: Model):
    """The parameter tree on the ``meta`` device."""
    return _meta_model(model).init(META)


def cache_shapes(model: Model, batch: int, max_len: int):
    """The serving cache on the ``meta`` device."""
    return _meta_model(model).init_cache(batch, max_len)


def input_specs(model: Model, shape_cfg):
    """Returns (args, arg_specs) for the step function of this shape."""
    B, S = shape_cfg.global_batch, shape_cfg.seq_len
    tok_spec = pspec("batch", "seq")
    if shape_cfg.kind == "train":
        args = {"tokens": _sds((B, S), torch.int32),
                "labels": _sds((B, S), torch.int32)}
        return args, {"tokens": tok_spec, "labels": tok_spec}
    cache = cache_shapes(model, B, S)
    if shape_cfg.kind == "prefill":
        args = {"tokens": _sds((B, S), torch.int32), "cache": cache}
        return args, {"tokens": tok_spec, "cache": model.cache_specs(B, S)}
    # decode: one new token against a seq_len-deep cache/state
    args = {"tok": _sds((B, 1), torch.int32), "cache": cache,
            "pos": _sds((B,), torch.int32)}
    return args, {"tok": tok_spec, "cache": model.cache_specs(B, S),
                  "pos": pspec("batch")}
