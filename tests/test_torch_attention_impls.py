"""The reference's chunked attention impls (``xla_chunked``,
``xla_unrolled``) in the port against the JAX package, on the CPU.

Both run when the sequence is longer than ``attn_chunk``, so the cases
use a small ``attn_chunk``: ``xla_chunked`` blocks of ``attn_chunk``,
``xla_unrolled`` blocks of ``max(attn_chunk, S // 8)``.  The same q, k, v
go through the reference's ``sdpa`` and the port's; then olmo-1b's
smoke model under each impl, with the reference's weights carried
across.  Tolerances as in ``tests/test_torch_models.py``: f32 1e-4, bf16
6e-2.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import attention as jattn
from repro.models.transformer import build_model as jbuild_model
from repro_torch import configs
from repro_torch.convert import params_from_reference
from repro_torch.models import attention as attn
from repro_torch.models.transformer import build_model

F32 = {"rtol": 1e-4, "atol": 1e-4}
BF16 = {"rtol": 6e-2, "atol": 6e-2}
IMPLS = ("xla_chunked", "xla_unrolled")
#: GQA (5 query heads a KV head), MQA and plain multi-head attention
ARCHS = ("qwen3-14b", "granite-20b", "olmo-1b")


def _cfgs(name, impl, dtype, chunk):
    return tuple(dataclasses.replace(c.get_smoke(name), attn_impl=impl,
                                     dtype=dtype, attn_chunk=chunk)
                 for c in (jconfigs, configs))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _qkv(cfg, S, seed=0, B=2):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, cfg.n_heads, cfg.head_dim), np.float32)
    k, v = (rng.standard_normal((B, S, cfg.n_kv_heads, cfg.head_dim),
                                np.float32) for _ in range(2))
    return q, k, v


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ARCHS)
@pytest.mark.parametrize("impl", IMPLS)
def test_sdpa_matches_reference_past_the_chunk(impl, name, dtype):
    """S = 48 over ``attn_chunk`` 4: 12 chunked blocks, or 8 unrolled
    blocks of 6 (S // 8 > attn_chunk)."""
    tol = F32 if dtype == "float32" else BF16
    jcfg, tcfg = _cfgs(name, impl, dtype, 4)
    q, k, v = _qkv(tcfg, 48)
    want = jattn.sdpa(jcfg, *(jnp.asarray(a, jcfg.act_dtype)
                              for a in (q, k, v)))
    got = attn.sdpa(tcfg, *(torch.from_numpy(a).to(tcfg.act_dtype)
                            for a in (q, k, v)))
    assert got.shape == want.shape and got.dtype == tcfg.act_dtype
    np.testing.assert_allclose(_np(got), _np(want), **tol)


@pytest.mark.parametrize("impl", IMPLS)
def test_chunk_sizes_and_the_naive_fallback(impl, monkeypatch):
    """The block size each impl takes, and ``S <= attn_chunk`` running the
    naive path (bit for bit)."""
    _, tcfg = _cfgs("qwen3-14b", impl, "float32", 4)
    seen = []
    real = attn._flash_blocks
    monkeypatch.setattr(attn, "_flash_blocks",
                        lambda q, k, v, qc, scale: seen.append(qc) or
                        real(q, k, v, qc, scale))
    for S in (48, 16):
        attn.sdpa(tcfg, *(torch.from_numpy(a) for a in _qkv(tcfg, S)))
    assert seen == ([4, 4] if impl == "xla_chunked" else [6, 4])
    small = [torch.from_numpy(a) for a in _qkv(tcfg, 4)]
    torch.testing.assert_close(attn.sdpa(tcfg, *small),
                               attn._sdpa_naive(*small), rtol=0, atol=0)
    assert seen == ([4, 4] if impl == "xla_chunked" else [6, 4])


def test_chunked_assertion_mirrors_reference():
    """``_sdpa_chunked`` asserts ``S % chunk == 0`` as the reference
    does; the unrolled impl asserts nothing and leaves a ragged tail out,
    as the reference's does."""
    jcfg, tcfg = _cfgs("olmo-1b", "xla_chunked", "float32", 5)
    q, k, v = _qkv(tcfg, 12)
    with pytest.raises(AssertionError):
        jattn._sdpa_chunked(*(jnp.asarray(a) for a in (q, k, v)), 5)
    with pytest.raises(AssertionError):
        attn._sdpa_chunked(*(torch.from_numpy(a) for a in (q, k, v)), 5)
    want = jattn._sdpa_unrolled(*(jnp.asarray(a) for a in (q, k, v)), 5)
    got = attn._sdpa_unrolled(*(torch.from_numpy(a) for a in (q, k, v)), 5)
    assert got.shape == want.shape == (2, 10, tcfg.n_heads, tcfg.head_dim)
    np.testing.assert_allclose(_np(got), _np(want), **F32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", ["xla_chunked", "xla_unrolled", "naive",
                                  "pallas"])
def test_olmo_forward_under_each_impl(impl, dtype):
    """olmo-1b's smoke model (its config's default impl is
    ``xla_chunked``) over 32 tokens with ``attn_chunk`` 8: the port's
    logits against the reference's under the same impl, and a prefill of
    24 tokens (a multiple of the chunk, as ``xla_chunked`` asserts) and
    two decode steps against its own forward."""
    tol = F32 if dtype == "float32" else BF16
    jcfg, tcfg = _cfgs("olmo-1b", impl, dtype, 8)
    jp = jbuild_model(jcfg).init(jax.random.key(3))
    tp = params_from_reference(tcfg, jax.tree.map(np.asarray, jp),
                               device="cpu")
    toks = np.random.default_rng(4).integers(0, tcfg.vocab, (2, 32))
    want, _ = jax.jit(jbuild_model(jcfg).forward)(
        jp, jnp.asarray(toks, jnp.int32))
    model = build_model(tcfg, device="cpu")
    got, aux = model.forward(tp, torch.from_numpy(toks))
    assert float(aux) == 0.0
    np.testing.assert_allclose(_np(got), _np(want), **tol)
    cache = model.init_cache(2, 40)
    logits, cache = model.prefill(tp, torch.from_numpy(toks[:, :24]), cache)
    steps = [logits]
    for i in (24, 25):
        logits, cache = model.decode_step(
            tp, torch.from_numpy(toks[:, i:i + 1]), cache,
            torch.full((2,), i, dtype=torch.int32))
        steps.append(logits)
    np.testing.assert_allclose(_np(torch.cat(steps, dim=1)),
                               _np(got[:, 23:26]), **tol)
