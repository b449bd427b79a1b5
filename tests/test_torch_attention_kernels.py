"""Port attention kernels' plain versions against the reference's Pallas
kernels (interpret mode on the CPU) and its jnp oracles.

The shapes, dtypes, decode positions and tolerances are
``tests/test_kernels.py``'s.  Inputs are drawn with numpy and cast to
bf16 identically on both sides.  The last test holds the CUDA kernels
against their plain versions and runs only where a card is present.
"""
import dataclasses
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention.ops import \
    decode_attention as jax_decode_attention
from repro.kernels.decode_attention.ref import \
    decode_attention_ref as jax_decode_ref
from repro.kernels.flash_attention.ops import \
    flash_attention as jax_flash_attention
from repro.kernels.flash_attention.ref import \
    flash_attention_ref as jax_flash_ref
from repro import configs as jconfigs
from repro_torch import NotPortedError
from repro_torch.kernels.decode_attention import kernel as dk
from repro_torch.kernels.decode_attention import ops as d_ops
from repro_torch.kernels.decode_attention.ref import decode_attention_ref
from repro_torch.kernels.flash_attention import kernel as fk
from repro_torch.kernels.flash_attention import ops as f_ops
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.models.transformer import check_ported

DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}
FLASH_SHAPES = [
    (2, 256, 4, 2, 64),    # GQA
    (1, 128, 8, 8, 128),   # MHA
    (2, 256, 4, 1, 128),   # MQA
    (1, 192, 6, 2, 32),    # uneven blocks (192 % 128 != 0)
]
DECODE_SHAPES = [(2, 512, 4, 2, 64), (3, 256, 8, 1, 128)]


def _tols(name):
    """``tests/test_kernels.py``'s ``_tols``."""
    return {"rtol": 2e-2, "atol": 2e-2} if name == "bf16" else \
        {"rtol": 2e-3, "atol": 2e-3}


def _pair(x, name):
    """The same values as a torch tensor and a jax array of one dtype."""
    tdt, jdt = DTYPES[name]
    return torch.from_numpy(x).to(tdt), jnp.asarray(x, jdt)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", FLASH_SHAPES, ids=str)
def test_flash_plain_matches_pallas_and_oracle(shape, dtype):
    B, S, H, KV, Dh = shape
    rng = np.random.default_rng(hash(shape) % 2**31)
    q, jq = _pair(rng.standard_normal((B, S, H, Dh), np.float32), dtype)
    k, jk = _pair(rng.standard_normal((B, S, KV, Dh), np.float32), dtype)
    v, jv = _pair(rng.standard_normal((B, S, KV, Dh), np.float32), dtype)
    out = f_ops.flash_attention(q, k, v)
    assert out.dtype == q.dtype and out.shape == q.shape
    pallas = jax_flash_attention(jq, jk, jv, bq=64, bk=64)
    oracle = jax_flash_ref(jq, jk, jv)
    np.testing.assert_allclose(_f32(out), _f32(pallas), **_tols(dtype))
    np.testing.assert_allclose(_f32(out), _f32(oracle), **_tols(dtype))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", DECODE_SHAPES, ids=str)
def test_decode_plain_matches_pallas_and_oracle(shape, dtype):
    B, S, H, KV, Dh = shape
    rng = np.random.default_rng(S + H)
    q, jq = _pair(rng.standard_normal((B, H, Dh), np.float32), dtype)
    k, jk = _pair(rng.standard_normal((B, S, KV, Dh), np.float32), dtype)
    v, jv = _pair(rng.standard_normal((B, S, KV, Dh), np.float32), dtype)
    pos_np = np.random.default_rng(0).integers(1, S, B).astype(np.int32)
    out = d_ops.decode_attention(q, k, v, torch.from_numpy(pos_np))
    assert out.dtype == q.dtype and out.shape == q.shape
    pallas = jax_decode_attention(jq, jk, jv, jnp.asarray(pos_np), bk=128)
    oracle = jax_decode_ref(jq, jk, jv, jnp.asarray(pos_np))
    np.testing.assert_allclose(_f32(out), _f32(pallas), **_tols(dtype))
    np.testing.assert_allclose(_f32(out), _f32(oracle), **_tols(dtype))


@pytest.mark.parametrize("pos", [0, 5, 63])
def test_decode_plain_ignores_rows_past_pos(pos):
    """Rows past ``pos`` hold no data: large values there change nothing
    (the plain version multiplies them by exact zeros; the kernel never
    reads them)."""
    rng = np.random.default_rng(pos)
    q = torch.from_numpy(rng.standard_normal((1, 4, 32), np.float32))
    k = torch.from_numpy(rng.standard_normal((1, 64, 2, 32), np.float32))
    v = torch.from_numpy(rng.standard_normal((1, 64, 2, 32), np.float32))
    p = torch.tensor([pos], dtype=torch.int32)
    out = d_ops.decode_attention(q, k, v, p)
    k2, v2 = k.clone(), v.clone()
    k2[:, pos + 1:] = 1e4
    v2[:, pos + 1:] = -1e4
    torch.testing.assert_close(d_ops.decode_attention(q, k2, v2, p), out,
                               rtol=0, atol=0)


def test_wrappers_take_plain_version_only_on_cpu():
    """``ops`` sends CPU tensors to the plain version (no launch counted);
    the kernel bindings refuse CPU tensors with a named error."""
    rng = np.random.default_rng(1)
    q = torch.from_numpy(rng.standard_normal((1, 16, 4, 32), np.float32))
    k = torch.from_numpy(rng.standard_normal((1, 16, 2, 32), np.float32))
    before = (fk.flash_attention.launches, dk.decode_attention.launches)
    torch.testing.assert_close(f_ops.flash_attention(q, k, k),
                               flash_attention_ref(q, k, k), rtol=0, atol=0)
    pos = torch.tensor([7], dtype=torch.int32)
    torch.testing.assert_close(d_ops.decode_attention(q[:, 0], k, k, pos),
                               decode_attention_ref(q[:, 0], k, k, pos),
                               rtol=0, atol=0)
    assert (fk.flash_attention.launches,
            dk.decode_attention.launches) == before
    with pytest.raises(ValueError, match="CUDA tensor"):
        fk.flash_attention(q, k, k)
    with pytest.raises(ValueError, match="CUDA tensor"):
        dk.decode_attention(q[:, 0], k, k, pos)


def test_head_dims_built_in_both_kernels():
    """Both CUDA sources instantiate exactly the head dims the wrappers
    accept, in every ``switch (head_dim)`` (the flash source has one for
    its f32 kernel and one for its bf16 kernel), and those cover the
    attention of every config of ``repro.configs`` that the port builds
    (zamba2-2.7b's shared block has Dh = 80, gemma-2b Dh = 256, dbrx-132b
    48 query heads on 8 KV heads at Dh = 128; deepseek-v2-236b's MLA runs
    no attention kernel), with query heads per KV head within the decode
    kernel's ``kMaxGroup``."""
    csrc = Path(fk.__file__).resolve().parents[2] / "csrc"
    for name, n_switches in (("flash_attention", 2), ("decode_attention", 1)):
        src = (csrc / f"{name}.cu").read_text()
        switches = src.split("switch (head_dim)")[1:]
        assert len(switches) == n_switches, (name, len(switches))
        for switch in switches:
            switch = switch[:switch.index("default:")]
            built = tuple(int(d) for d in re.findall(r"case (\d+):", switch))
            assert built == fk.HEAD_DIMS, (name, built)
    max_group = re.search(r"constexpr int kMaxGroup = (\d+);",
                          (csrc / "decode_attention.cu").read_text())
    assert int(max_group.group(1)) == dk.MAX_GROUP == 64
    built = []
    for name in jconfigs.ARCH_NAMES:
        cfg = dataclasses.replace(jconfigs.get(name), attn_impl="pallas")
        try:
            check_ported(cfg)
        except NotPortedError:
            continue
        built.append(name)
        # rwkv6 has no attention; MLA's attention is the reference's
        # einsums, no kernel (its head_dim is only informational)
        if cfg.family == "rwkv6" or cfg.mla is not None:
            continue
        assert cfg.head_dim in fk.HEAD_DIMS, (name, cfg.head_dim)
        assert cfg.n_heads % cfg.n_kv_heads == 0, name
        assert cfg.n_heads // cfg.n_kv_heads <= dk.MAX_GROUP, name
    assert {"olmo-1b", "musicgen-large", "zamba2-2.7b", "gemma-2b",
            "rwkv6-3b", "dbrx-132b", "deepseek-v2-236b"} <= set(built), built


def test_cuda_kernels_match_plain_versions():
    """On the card: both kernels against their plain versions at ragged
    and served shapes, f32 at 1e-4 and bf16 at 2e-2."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; python3 chip_smoke.py runs the "
                    "full check there")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for name, (dt, _) in DTYPES.items():
        tol = 2e-2 if name == "bf16" else 1e-4
        for B, S, H, KV, Dh in FLASH_SHAPES + [(1, 777, 16, 16, 128),
                                               (1, 777, 32, 32, 80)]:
            q, k, v = (torch.randn((B, S, n, Dh), generator=gen,
                                   device="cuda").to(dt)
                       for n in (H, KV, KV))
            torch.testing.assert_close(
                fk.flash_attention(q, k, v).float(),
                flash_attention_ref(q, k, v).float(), rtol=tol, atol=tol)
        for B, S, H, KV, Dh in DECODE_SHAPES + [(1, 2048, 32, 32, 80)]:
            q = torch.randn((B, H, Dh), generator=gen, device="cuda").to(dt)
            k, v = (torch.randn((B, S, KV, Dh), generator=gen,
                                device="cuda").to(dt) for _ in range(2))
            pos = torch.randint(0, S, (B,), generator=gen, device="cuda",
                                dtype=torch.int32)
            torch.testing.assert_close(
                dk.decode_attention(q, k, v, pos).float(),
                decode_attention_ref(q, k, v, pos).float(), rtol=tol,
                atol=tol)
