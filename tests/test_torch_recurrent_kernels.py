"""Port recurrent-scan kernels' plain versions against the reference's
Pallas kernels (interpret mode on the CPU), its models' chunked scans and
its per-step oracles.

The shapes and chunks are ``tests/test_kernels.py``'s, with its input
laws; inputs are drawn with numpy.  Tolerances:

* f32 within 1e-4 against the same algorithm in JAX (the per-step
  oracle against ``wkv6_ref``/``ssd_ref``, the chunked form against the
  models' ``wkv_chunked``/``ssd_chunked``): the same f32 math in another
  summation order;
* f32 within ``tests/test_kernels.py``'s 2e-3 against the interpret-mode
  Pallas kernel and across algorithms (chunked against per-step);
* bf16 activations (f32 decay, dt and state) within 6e-2
  (``tests/test_models.py``'s bf16 tolerance): y is rounded to bf16.

The last test holds the CUDA kernels against their plain versions and
runs only where a card is present.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.mamba2_ssd.ops import ssd as jax_ssd
from repro.kernels.mamba2_ssd.ref import ssd_ref as jax_ssd_ref
from repro.kernels.rwkv6_wkv.ops import wkv6 as jax_wkv6
from repro.kernels.rwkv6_wkv.ref import wkv6_ref as jax_wkv6_ref
from repro.models.mamba2 import ssd_chunked as jax_ssd_chunked
from repro.models.rwkv6 import wkv_chunked as jax_wkv_chunked
from repro_torch.kernels import pieces
from repro_torch.kernels.mamba2_ssd import kernel as sk
from repro_torch.kernels.mamba2_ssd import ops as s_ops
from repro_torch.kernels.mamba2_ssd.ref import (ssd_chunk_parallel_ref,
                                                ssd_chunked_ref, ssd_ref)
from repro_torch.kernels.rwkv6_wkv import kernel as wk
from repro_torch.kernels.rwkv6_wkv import ops as w_ops
from repro_torch.kernels.rwkv6_wkv import ref as w_ref
from repro_torch.kernels.rwkv6_wkv.ref import (wkv6_chunk_parallel_ref,
                                               wkv6_chunked_ref, wkv6_ref)

SAME = {"rtol": 1e-4, "atol": 1e-4}
ACROSS = {"rtol": 2e-3, "atol": 2e-3}
BF16 = {"rtol": 6e-2, "atol": 6e-2}
WKV_SHAPES = [(2, 128, 3, 64), (1, 64, 2, 64)]
SSD_SHAPES = [(2, 128, 4, 32, 16), (1, 64, 2, 16, 8)]


def wkv_inputs(shape, seed, state=False, decay=0.0):
    """``tests/test_kernels.py``'s laws: r, k, v ~ N(0, 0.25), lw =
    -exp(N(decay, 1)) (decay 0 there), u ~ N(0, 0.01); a carry-in state
    ~ N(0, 1) if asked."""
    B, T, H, K = shape
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal(shape, np.float32) * 0.5
               for _ in range(3))
    lw = -np.exp(rng.standard_normal(shape, np.float32) + np.float32(decay))
    u = rng.standard_normal((H, K), np.float32) * 0.1
    s0 = rng.standard_normal((B, H, K, K), np.float32) if state else None
    return r, k, v, lw, u, s0


def ssd_inputs(shape, seed, state=False):
    """``tests/test_kernels.py``'s laws: x ~ N(0, 1), dt = softplus(N(0,
    1)), B, C ~ N(0, 0.25), a = -exp(linspace(-1, 1, H)); a carry-in
    state ~ N(0, 1) if asked."""
    B, T, H, P, N = shape
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, H, P), np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, T, H), np.float32)))
    bm, cm = (rng.standard_normal((B, T, N), np.float32) * 0.5
              for _ in range(2))
    a = -np.exp(np.linspace(-1, 1, H, dtype=np.float32))
    h0 = rng.standard_normal((B, H, P, N), np.float32) if state else None
    return x, dt, bm, cm, a, h0


def _t(x, dtype=torch.float32):
    return None if x is None else torch.from_numpy(x).to(dtype)


def _j(x, dtype=jnp.float32):
    return None if x is None else jnp.asarray(x, dtype)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, tol):
    for g, w in zip(got, want):
        np.testing.assert_allclose(_f32(g), _f32(w), **tol)


# ---------------------------------------------------------------------------
# WKV-6
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("chunk", [16, 32])
@pytest.mark.parametrize("shape", WKV_SHAPES, ids=str)
def test_wkv_plain_matches_pallas_and_oracle(shape, chunk):
    r, k, v, lw, u, _ = wkv_inputs(shape, shape[1] * shape[2])
    t_args = [_t(a) for a in (r, k, v, lw, u)]
    j_args = [_j(a) for a in (r, k, v, lw, u)]
    step = wkv6_ref(*t_args)
    chunked = wkv6_chunked_ref(*t_args, chunk=chunk)
    _close(step, jax_wkv6_ref(*j_args), SAME)
    zero = jnp.zeros((shape[0], shape[2], shape[3], shape[3]), jnp.float32)
    _close(chunked, jax_wkv_chunked(*j_args, zero, chunk=chunk), SAME)
    _close(chunked, jax_wkv6(*j_args, chunk=chunk), ACROSS)
    _close(chunked, step, ACROSS)


@pytest.mark.parametrize("T", [77, 5])
def test_wkv_plain_ragged_with_carry_in(T):
    """A ragged tail (T % chunk != 0, and T < chunk) from a nonzero
    state, against the model's chunked scan and the oracle with ``s0``."""
    shape = (2, T, 2, 64)
    r, k, v, lw, u, s0 = wkv_inputs(shape, T, state=True)
    t_args = [_t(a) for a in (r, k, v, lw, u, s0)]
    j_args = [_j(a) for a in (r, k, v, lw, u, s0)]
    chunked = wkv6_chunked_ref(*t_args, chunk=32)
    assert chunked[0].shape == shape and chunked[1].shape == (2, 2, 64, 64)
    _close(chunked, jax_wkv_chunked(*j_args, chunk=32), SAME)
    _close(wkv6_ref(*t_args), jax_wkv6_ref(*j_args), SAME)
    _close(chunked, jax_wkv6_ref(*j_args), ACROSS)


def test_wkv_plain_bf16_matches_model_path():
    r, k, v, lw, u, s0 = wkv_inputs((1, 96, 2, 64), 3, state=True)
    got = wkv6_chunked_ref(*(_t(a, torch.bfloat16) for a in (r, k, v)),
                           *(_t(a) for a in (lw, u, s0)), chunk=32)
    want = jax_wkv_chunked(*(_j(a, jnp.bfloat16) for a in (r, k, v)),
                           *(_j(a) for a in (lw, u, s0)), chunk=32)
    assert got[0].dtype == torch.bfloat16 and got[1].dtype == torch.float32
    _close(got, want, BF16)


# the CUDA kernels' three passes (chunk states, state passing, outputs) in
# plain torch: (B, T, H, K), chunk, carry-in, lw's log-mean.
# tests/test_kernels.py's shapes and chunks, a cold start's T = 8 (chunk
# 8), a ragged T with a carry-in state, rwkv6-3b's widths (H = 40, K = 64)
# at T = 300, and strong decay (lw = -exp(N(2, 1)): e^{lc} and e^{lx} near 0)
WKV_CHUNK_PARALLEL_CASES = [
    *((shape, c, False, 0.0) for shape in WKV_SHAPES for c in (16, 32)),
    ((1, 8, 3, 64), 8, False, 0.0),
    ((2, 77, 2, 64), 32, True, 0.0),
    ((1, 300, 40, 64), 32, True, 0.0),
    ((2, 77, 3, 64), 32, True, 2.0),
]


@pytest.mark.parametrize("shape, chunk, state, decay",
                         WKV_CHUNK_PARALLEL_CASES, ids=str)
def test_wkv_chunk_parallel_ref_matches_pallas_and_chunked(shape, chunk,
                                                          state, decay):
    """``wkv6_chunk_parallel_ref`` (the kernels' passes, 16-row tiles and
    bf16 piece products) against the plain chunked form and the
    reference: its Pallas kernel in interpret mode where that takes the
    case (T a multiple of the chunk, no carry-in), else its model's
    ``wkv_chunked``.  f32 within 1e-4; bf16 activations: y within 2e-2
    (y is rounded to bf16) and the f32 state within 2e-3.  Finite under
    strong decay."""
    r, k, v, lw, u, s0 = wkv_inputs(shape, shape[1] + shape[2], state,
                                    decay)
    t_args = [_t(a) for a in (r, k, v, lw, u, s0)]
    j_args = [_j(a) for a in (r, k, v, lw, u)]
    B, T, H, K = shape
    s0_j = _j(s0) if state else jnp.zeros((B, H, K, K), jnp.float32)
    got = wkv6_chunk_parallel_ref(*t_args, chunk=chunk)
    assert got[0].shape == shape and got[0].dtype == torch.float32
    assert got[1].shape == (B, H, K, K)
    assert all(bool(g.isfinite().all()) for g in got)
    _close(got, wkv6_chunked_ref(*t_args, chunk=chunk), SAME)
    pallas = not state and T % chunk == 0
    if pallas:
        _close(got, jax_wkv6(*j_args, chunk=chunk), SAME)
    else:
        _close(got, jax_wkv_chunked(*j_args, s0_j, chunk=chunk), SAME)

    b_args = [_t(a, torch.bfloat16) for a in (r, k, v)] + t_args[3:]
    got = wkv6_chunk_parallel_ref(*b_args, chunk=chunk)
    assert got[0].dtype == torch.bfloat16 and got[1].dtype == torch.float32
    jb = [_j(a, jnp.bfloat16) for a in (r, k, v)] + j_args[3:]
    for want in (wkv6_chunked_ref(*b_args, chunk=chunk),
                 jax_wkv6(*jb, chunk=chunk) if pallas
                 else jax_wkv_chunked(*jb, s0_j, chunk=chunk)):
        np.testing.assert_allclose(_f32(got[0]), _f32(want[0]), rtol=2e-2,
                                   atol=2e-2)
        np.testing.assert_allclose(_f32(got[1]), _f32(want[1]), rtol=2e-3,
                                   atol=2e-3)


@pytest.mark.parametrize("decay", [0.0, 2.0])
def test_wkv_chunk_parallel_ref_cuts_products_as_the_kernel(decay):
    """A of one chunk as the output kernel builds it, against the pairwise
    scores in f64.  Below the diagonal 8-row blocks, a product of
    r·e^{lx − lx_j} and k·e^{lx_j − li}, each cut into bf16 hi and lo
    pieces, matches to about 2^-16 of Σ|terms| (three pieces of each:
    2^-24); inside them, the decays as running products of e^{li − lx}
    match to f32 rounding; all finite under strong decay."""
    rng = np.random.default_rng(5)
    c, K = 64, 64
    r, k = (torch.from_numpy(rng.standard_normal((3, c, K), np.float32))
            for _ in range(2))
    lw = -torch.exp(torch.from_numpy(
        rng.standard_normal((3, c, K), np.float32)) + decay)
    u = torch.from_numpy(rng.standard_normal(K, np.float32))
    li = torch.cumsum(lw, dim=1)
    lx = torch.nn.functional.pad(li[:, :-1], (0, 0, 1, 0))
    expo = (lx[:, :, None].double() - li[:, None].double()).clamp(max=0)
    terms = r[:, :, None].double() * k[:, None].double() * torch.exp(expo)
    strict = torch.ones(c, c).tril(-1).bool()
    want = torch.where(strict, terms.sum(-1), 0.0) + torch.diag_embed(
        (r.double() * u.double() * k.double()).sum(-1))
    scale = torch.where(strict, terms.abs().sum(-1), 0.0).max()
    idx = torch.arange(c) // 8
    blocks = idx[:, None] == idx[None, :]
    for nf, tol in ((2, 2 ** -15), (3, 2 ** -22)):
        got = w_ref._scores(r, k, u, lx, li, nf)
        assert bool(got.isfinite().all())
        err = (got.double() - want).abs()
        assert float(err[:, ~blocks].max()) <= tol * scale, nf
        assert float(err[:, blocks].max()) <= 2 ** -18 * scale, nf


# ---------------------------------------------------------------------------
# Mamba-2 SSD
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("chunk", [32, 64])
@pytest.mark.parametrize("shape", SSD_SHAPES, ids=str)
def test_ssd_plain_matches_pallas_and_oracle(shape, chunk):
    x, dt, bm, cm, a, _ = ssd_inputs(shape, shape[1] * shape[3])
    t_args = [_t(z) for z in (x, dt, bm, cm, a)]
    j_args = [_j(z) for z in (x, dt, bm, cm, a)]
    step = ssd_ref(*t_args)
    chunked = ssd_chunked_ref(*t_args, chunk=chunk)
    _close(step, jax_ssd_ref(*j_args), SAME)
    B, _, H, P, N = shape
    zero = jnp.zeros((B, H, P, N), jnp.float32)
    _close(chunked, jax_ssd_chunked(*j_args, zero, chunk=chunk), SAME)
    _close(chunked, jax_ssd(*j_args, chunk=chunk), ACROSS)
    _close(chunked, step, ACROSS)


@pytest.mark.parametrize("T", [77, 5])
def test_ssd_plain_ragged_with_carry_in(T):
    shape = (2, T, 3, 16, 8)
    x, dt, bm, cm, a, h0 = ssd_inputs(shape, T, state=True)
    t_args = [_t(z) for z in (x, dt, bm, cm, a, h0)]
    j_args = [_j(z) for z in (x, dt, bm, cm, a, h0)]
    chunked = ssd_chunked_ref(*t_args, chunk=32)
    assert chunked[0].shape == shape[:4] and chunked[1].shape == (2, 3, 16, 8)
    _close(chunked, jax_ssd_chunked(*j_args, chunk=32), SAME)
    _close(ssd_ref(*t_args), jax_ssd_ref(*j_args), SAME)
    _close(chunked, jax_ssd_ref(*j_args), ACROSS)


def test_ssd_plain_bf16_matches_model_path():
    x, dt, bm, cm, a, h0 = ssd_inputs((1, 96, 2, 32, 16), 4, state=True)
    got = ssd_chunked_ref(_t(x, torch.bfloat16), _t(dt),
                          *(_t(z, torch.bfloat16) for z in (bm, cm)),
                          _t(a), _t(h0), chunk=32)
    want = jax_ssd_chunked(_j(x, jnp.bfloat16), _j(dt),
                           *(_j(z, jnp.bfloat16) for z in (bm, cm)),
                           _j(a), _j(h0), chunk=32)
    assert got[0].dtype == torch.bfloat16 and got[1].dtype == torch.float32
    _close(got, want, BF16)


# the CUDA kernel's three passes (chunk states, state passing, outputs) in
# plain torch: (B, T, H, P, N), chunk, carry-in.  tests/test_kernels.py's
# shapes and chunks, a cold start's T = 8 (chunk 8), a ragged T with a
# carry-in state, and zamba2-2.7b's widths (H = 80, P = N = 64) at T = 300
CHUNK_PARALLEL_CASES = [
    *((shape, c, False) for shape in SSD_SHAPES for c in (32, 64)),
    ((1, 8, 3, 16, 8), 8, False),
    ((2, 77, 3, 16, 8), 32, True),
    ((1, 300, 80, 64, 64), 128, True),
]


def _bf16_inputs(x, dt, bm, cm, a, h0):
    return (_t(x, torch.bfloat16), _t(dt), _t(bm, torch.bfloat16),
            _t(cm, torch.bfloat16), _t(a), _t(h0))


@pytest.mark.parametrize("shape, chunk, state", CHUNK_PARALLEL_CASES,
                         ids=str)
def test_ssd_chunk_parallel_ref_matches_pallas_and_chunked(shape, chunk,
                                                          state):
    """``ssd_chunk_parallel_ref`` (the kernel's passes and its bf16 piece
    products) against the plain chunked form and the reference: its
    Pallas kernel in interpret mode where that takes the case (T a
    multiple of the chunk, no carry-in), else its model's
    ``ssd_chunked``.  f32 within 1e-4; bf16 activations: y within 2e-2
    (y is rounded to bf16) and the f32 state within 2e-3."""
    x, dt, bm, cm, a, h0 = ssd_inputs(shape, shape[1] + shape[2], state)
    t_args = [_t(z) for z in (x, dt, bm, cm, a, h0)]
    j_args = [_j(z) for z in (x, dt, bm, cm, a)]
    got = ssd_chunk_parallel_ref(*t_args, chunk=chunk)
    assert got[0].shape == shape[:4] and got[0].dtype == torch.float32
    assert got[1].shape == (shape[0], shape[2], shape[3], shape[4])
    _close(got, ssd_chunked_ref(*t_args, chunk=chunk), SAME)
    pallas = not state and shape[1] % chunk == 0
    if pallas:
        _close(got, jax_ssd(*j_args, chunk=chunk), SAME)
    else:
        _close(got, jax_ssd_chunked(*j_args, _j(h0), chunk=chunk), SAME)

    b_args = _bf16_inputs(x, dt, bm, cm, a, h0)
    got = ssd_chunk_parallel_ref(*b_args, chunk=chunk)
    assert got[0].dtype == torch.bfloat16 and got[1].dtype == torch.float32
    jb = [_j(x, jnp.bfloat16), _j(dt), _j(bm, jnp.bfloat16),
          _j(cm, jnp.bfloat16), _j(a)]
    for want in (ssd_chunked_ref(*b_args, chunk=chunk),
                 jax_ssd(*jb, chunk=chunk) if pallas
                 else jax_ssd_chunked(*jb, _j(h0), chunk=chunk)):
        np.testing.assert_allclose(_f32(got[0]), _f32(want[0]), rtol=2e-2,
                                   atol=2e-2)
        np.testing.assert_allclose(_f32(got[1]), _f32(want[1]), rtol=2e-3,
                                   atol=2e-3)


def test_ssd_chunk_parallel_ref_cuts_products_as_the_kernel():
    """The piece products: an f32 factor in bf16 hi and lo pieces matches
    f32 to about 2^-16; three pieces of an f32 input to about 2^-24; one
    piece of a bf16 input is exact."""
    rng = np.random.default_rng(3)
    a = torch.from_numpy(rng.standard_normal((64, 48), np.float32))
    b = torch.from_numpy(rng.standard_normal((48, 32), np.float32))
    scale = float((a.abs().double() @ b.abs().double()).max())
    for na, nb, tol in ((2, 1, 2 ** -15), (3, 3, 2 ** -22)):
        bb = b if nb > 1 else b.to(torch.bfloat16).float()
        want = (a.double() @ bb.double()).float()
        got = pieces.split_einsum("ik,kj->ij", a, na, bb, nb)
        assert float((got - want).abs().max()) <= tol * scale, (na, nb)
    ab, bb = a.to(torch.bfloat16).float(), b.to(torch.bfloat16).float()
    torch.testing.assert_close(pieces.split_einsum("ik,kj->ij", ab, 1, bb, 1),
                               ab @ bb, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("T, chunk", [(8, 128), (777, 128), (1500, 128),
                                      (64, 32)])
def test_ssd_heads_per_block_from_shapes(T, chunk):
    """The output pass's head groups come from the shapes alone: at most
    :data:`MAX_HEADS_PER_BLOCK` heads a block, and no more waves of
    resident blocks than one head a block would take."""
    n_chunks, slots = -(-T // chunk), 2 * 132
    g = sk.heads_per_block(80, n_chunks, 1, slots)
    assert 1 <= g <= sk.MAX_HEADS_PER_BLOCK
    waves = -(-(n_chunks * -(-80 // g)) // slots)
    assert waves <= -(-(n_chunks * 80) // slots)
    if n_chunks * 80 <= slots:       # one head a block fits in one wave
        assert g == 1
    assert sk.heads_per_block(3, 1, 1, slots) == 1


# ---------------------------------------------------------------------------
# wrappers and the card
# ---------------------------------------------------------------------------

def test_wrappers_take_plain_version_only_on_cpu():
    """``ops`` sends CPU tensors to the plain chunked form (no launch
    counted); the kernel bindings refuse CPU tensors with a named error."""
    w_args = [_t(a) for a in wkv_inputs((1, 40, 2, 64), 1, state=True)]
    s_args = [_t(z) for z in ssd_inputs((1, 40, 2, 16, 8), 1, state=True)]
    before = (wk.wkv6.launches, sk.ssd.launches)
    _close(w_ops.wkv6(*w_args, chunk=16),
           wkv6_chunked_ref(*w_args, chunk=16), {"rtol": 0, "atol": 0})
    _close(s_ops.ssd(*s_args, chunk=16), ssd_chunked_ref(*s_args, chunk=16),
           {"rtol": 0, "atol": 0})
    assert (wk.wkv6.launches, sk.ssd.launches) == before
    with pytest.raises(ValueError, match="CUDA tensor"):
        wk.wkv6(*w_args)
    with pytest.raises(ValueError, match="CUDA tensor"):
        sk.ssd(*s_args)


def test_cuda_kernels_match_plain_versions():
    """On the card: both scan kernels against their plain chunked forms,
    f32 within 1e-4 and bf16 activations within 2e-2 (y) and 2e-3 (the
    f32 state), at ragged and served shapes, with and without a carry-in
    state."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; python3 chip_smoke.py runs the "
                    "full check there")
    for dt, y_tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
        s_tol = 1e-4 if dt == torch.float32 else 2e-3
        for shape, chunk, state in (((2, 128, 3, 64), 16, False),
                                    ((1, 777, 40, 64), 32, True)):
            args = [_t(a).cuda() if a is not None else None
                    for a in wkv_inputs(shape, 0, state)]
            args[:3] = [a.to(dt) for a in args[:3]]
            got = wk.wkv6(*args, chunk=chunk)
            want = wkv6_chunked_ref(*args, chunk=chunk)
            for g, w, tol in zip(got, want, (y_tol, s_tol)):
                torch.testing.assert_close(g.float(), w.float(), rtol=tol,
                                           atol=tol)
        for shape, chunk, state in (((2, 128, 4, 32, 16), 32, False),
                                    ((1, 777, 80, 64, 64), 128, True)):
            args = [_t(z).cuda() if z is not None else None
                    for z in ssd_inputs(shape, 0, state)]
            args[0], args[2], args[3] = (args[i].to(dt) for i in (0, 2, 3))
            got = sk.ssd(*args, chunk=chunk)
            want = ssd_chunked_ref(*args, chunk=chunk)
            for g, w, tol in zip(got, want, (y_tol, s_tol)):
                torch.testing.assert_close(g.float(), w.float(), rtol=tol,
                                           atol=tol)
