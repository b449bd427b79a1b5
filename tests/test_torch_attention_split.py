"""The attention kernels' arithmetic in plain torch, against the
reference's Pallas kernels (interpret mode on the CPU) and its oracles.

* Split-KV decode: ``decode_partials`` per split of the cache, then
  ``combine_partials``, is the function of ``decode_attention_ref`` and of
  the Pallas ``decode_attention_hm``, in f32 within 1e-5 (the same f32
  math in another summation order), at ``tests/test_kernels.py``'s shapes
  and the served GQA (qwen3-14b) and MQA (granite-20b) heads; splits that
  start past ``pos`` and ``pos = 0`` included.
* The split the wrapper picks on the host (``split_rows``): at least
  2 × 132 blocks at every decode shape ``chip_smoke.py`` times, never an
  empty grid, whole 64-row chunks, the whole cache covered.
* The bf16 flash kernel rounds p to bf16 before ``p·V`` where the Pallas
  kernel keeps it f32: ``flash_attention_tiled_ref`` does the same, and
  stays within ``tests/test_kernels.py``'s bf16 tolerance of the Pallas
  kernel (2e-2, ``chip_smoke.py`` phase 6's); in f32 it is
  ``flash_attention_ref`` within 1e-5.
* The 16-byte alignment contract of the kernels' copies.
"""
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention.ops import \
    decode_attention as jax_decode_attention
from repro.kernels.flash_attention.ops import \
    flash_attention as jax_flash_attention
from repro_torch.kernels.decode_attention import kernel as dk
from repro_torch.kernels.decode_attention.ref import (
    NEG_INF, combine_partials, decode_attention_ref, decode_partials,
    decode_attention_split_ref)
from repro_torch.kernels.flash_attention import kernel as fk
from repro_torch.kernels.flash_attention.ref import (
    flash_attention_ref, flash_attention_tiled_ref)

F32 = {"rtol": 1e-5, "atol": 1e-5}
BF16 = {"rtol": 2e-2, "atol": 2e-2}
#: tests/test_kernels.py's decode shapes, then qwen3-14b's GQA (40 / 8) and
#: granite-20b's MQA (48 / 1) heads at the served cache length
DECODE_SHAPES = [(2, 512, 4, 2, 64), (3, 256, 8, 1, 128),
                 (1, 2048, 40, 8, 128), (1, 2048, 48, 1, 128)]
#: tests/test_kernels.py's flash shapes
FLASH_SHAPES = [(2, 256, 4, 2, 64), (1, 128, 8, 8, 128), (2, 256, 4, 1, 128),
                (1, 192, 6, 2, 32)]


def _chip_smoke():
    """``chip_smoke.py``'s module (constants only are read; it imports no
    torch at module level)."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _decode_inputs(shape, pos):
    B, S, H, KV, Dh = shape
    rng = np.random.default_rng(S + H + KV)
    q, k, v = (rng.standard_normal(s, np.float32)
               for s in ((B, H, Dh), (B, S, KV, Dh), (B, S, KV, Dh)))
    return q, k, v, np.asarray(pos, np.int32)


@pytest.mark.parametrize("rows", [64, 128, 192])
@pytest.mark.parametrize("shape", DECODE_SHAPES, ids=str)
def test_split_decode_matches_ref_and_pallas(shape, rows):
    B, S = shape[:2]
    pos = np.random.default_rng(0).integers(1, S, B)
    q, k, v, pos = _decode_inputs(shape, pos)
    tq, tk, tv, tp = (torch.from_numpy(x) for x in (q, k, v, pos))
    got = decode_attention_split_ref(tq, tk, tv, tp, rows)
    assert got.dtype == torch.float32 and got.shape == tq.shape
    want = decode_attention_ref(tq, tk, tv, tp)
    torch.testing.assert_close(got, want, **F32)
    pallas = jax_decode_attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), jnp.asarray(pos), bk=128)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), **F32)


@pytest.mark.parametrize("pos", [0, 63, 64, 65, 511])
def test_split_decode_empty_splits(pos):
    """Splits that start past ``pos`` are empty partials and weigh nothing;
    at ``pos = 0`` only row 0 counts, so the output is v's row 0."""
    shape = (2, 512, 4, 2, 64)
    q, k, v, p = _decode_inputs(shape, [pos, 511 - pos])
    tq, tk, tv, tp = (torch.from_numpy(x) for x in (q, k, v, p))
    m, l, acc = decode_partials(tq, tk, tv, tp, 64)
    assert m.shape == l.shape == (8, 2, 4) and acc.shape == (8, 2, 4, 64)
    for b, pb in enumerate((pos, 511 - pos)):
        empty = torch.arange(8) * 64 > pb
        assert bool((m[empty, b] == NEG_INF).all())
        assert bool((l[empty, b] == 0).all())
        assert bool((acc[empty, b] == 0).all())
        assert bool((l[~empty, b] >= 1).all())
    got = combine_partials(m, l, acc, torch.float32)
    torch.testing.assert_close(got, decode_attention_ref(tq, tk, tv, tp),
                               **F32)
    pallas = jax_decode_attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), jnp.asarray(p), bk=128)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), **F32)
    if pos == 0:
        torch.testing.assert_close(got[0], tv[0, 0].repeat_interleave(2, 0),
                                   rtol=0, atol=0)


def test_split_rows_fill_the_card_at_the_timed_shapes():
    for B, S, H, KV, Dh, pos in _chip_smoke().DECODE_TIMED:
        rows, n_split = dk.split_rows(S, KV, B)
        assert KV * n_split * B >= 2 * dk.N_SMS, (S, KV, rows, n_split)


def test_chip_check_covers_every_split_kernel_path():
    """``chip_smoke.py`` phase 6 holds the kernel against its plain version
    with one-chunk and several-chunk bf16 splits (the two-stage ring), for
    the narrow kernel (one p·V unit per thread) and the wide one."""
    paths = set()
    for B, S, H, KV, Dh, _ in _chip_smoke().DECODE_CASES:
        rows, _ = dk.split_rows(S, KV, B)
        paths.add((rows > dk.SPLIT_QUANTUM, (H // KV) * (Dh // 8) > 128))
    assert paths == {(False, False), (False, True), (True, False),
                     (True, True)}


@pytest.mark.parametrize("s_max", [1, 63, 64, 65, 777, 2048, 4096, 10**7])
@pytest.mark.parametrize("kv_b", [(1, 1), (8, 1), (16, 1), (32, 1), (8, 64),
                                  (32, 65535)])
def test_split_rows_cover_the_cache(s_max, kv_b):
    """Never an empty grid, whole 64-row chunks per split, the whole cache
    covered and no split wholly past it, and a split axis CUDA launches."""
    KV, B = kv_b
    rows, n_split = dk.split_rows(s_max, KV, B)
    assert rows % dk.SPLIT_QUANTUM == 0 and rows >= dk.SPLIT_QUANTUM
    assert 1 <= n_split <= dk.MAX_SPLITS
    assert (n_split - 1) * rows < s_max <= n_split * rows


@pytest.mark.parametrize("shape", FLASH_SHAPES, ids=str)
def test_tiled_flash_bf16_p_within_pallas(shape):
    """p rounded to bf16 before ``p·V`` (the bf16 kernel's divergence from
    the Pallas kernel) stays inside the bf16 tolerance."""
    B, S, H, KV, Dh = shape
    rng = np.random.default_rng(hash(shape) % 2**31)
    xs = [rng.standard_normal((B, S, n, Dh), np.float32) for n in (H, KV, KV)]
    tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16) for x in xs)
    got = flash_attention_tiled_ref(tq, tk, tv)
    assert got.dtype == torch.bfloat16 and got.shape == tq.shape
    pallas = jax_flash_attention(*(jnp.asarray(x, jnp.bfloat16) for x in xs),
                                 bq=64, bk=64)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(pallas, np.float32), **BF16)


@pytest.mark.parametrize("shape", FLASH_SHAPES, ids=str)
def test_tiled_flash_f32_is_the_plain_version(shape):
    B, S, H, KV, Dh = shape
    rng = np.random.default_rng(hash(shape) % 2**31)
    tq, tk, tv = (torch.from_numpy(rng.standard_normal((B, S, n, Dh),
                                                       np.float32))
                  for n in (H, KV, KV))
    torch.testing.assert_close(flash_attention_tiled_ref(tq, tk, tv),
                               flash_attention_ref(tq, tk, tv), **F32)


def test_alignment_contract():
    """Aligned data with strides in multiples of 8 elements pass; a view one
    element off, or a row stride that is not a multiple of 8, is refused
    (the CUDA wrappers run this check before launching)."""
    cache = torch.zeros((1, 64, 2, 64), dtype=torch.bfloat16)
    fk.check_aligned("t", (cache, cache[:, 3:], cache[..., 8:24]))
    flat = torch.zeros(1 + cache.numel(), dtype=torch.bfloat16)
    with pytest.raises(fk.UnsupportedShapeError, match="16-byte"):
        fk.check_aligned("t", (flat[1:].view(cache.shape),))
    wide = torch.zeros((1, 64, 2, 65), dtype=torch.bfloat16)
    with pytest.raises(fk.UnsupportedShapeError, match="16-byte"):
        fk.check_aligned("t", (wide[..., :64],))
