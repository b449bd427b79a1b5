"""Port ``hermes_select`` against the reference's Pallas kernel (interpret
mode on the CPU) and its numpy oracle.  Choices and loads must be equal.

The last test holds the CUDA kernel against its plain version and runs
only where a card is present, so the same file also runs on the card's
machine: ``python -m pytest tests/test_torch_hermes_select.py``.  Where
JAX is not installed, the reference-side tests skip.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.hermes_select.ops import hermes_select
from repro_torch.kernels.hermes_select.ref import hermes_select_ref

try:
    import jax.numpy as jnp
    from repro.kernels.hermes_select.ops import \
        hermes_select as jax_hermes_select
    from repro.kernels.hermes_select.ref import hermes_select_ref as np_ref
except ImportError:     # no JAX installed: the reference tests skip
    jnp = None


@pytest.fixture
def reference():
    if jnp is None:
        pytest.skip("the JAX reference package is not installed here")


def _case(rng, W, F, N, cores, slots=None, lo=0, hi=None):
    slots = cores * 8 if slots is None else slots
    active = rng.integers(lo, slots if hi is None else hi, W).astype(np.int32)
    warm = rng.integers(0, 3, (W, F)).astype(np.int32)
    funcs = rng.integers(0, F, N).astype(np.int32)
    return active, warm, funcs, cores, slots


def _check_against_reference(active, warm, funcs, cores, slots):
    out, act = hermes_select(active, warm, funcs, cores=cores, slots=slots,
                             device="cpu")
    jo, ja = jax_hermes_select(jnp.asarray(active), jnp.asarray(warm),
                               jnp.asarray(funcs), cores=cores, slots=slots)
    ro, ra = np_ref(active, warm.T[funcs], cores=cores, slots=slots)
    assert out.dtype == torch.int32 and act.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), np.asarray(jo))
    np.testing.assert_array_equal(act.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(out.numpy(), ro)
    np.testing.assert_array_equal(act.numpy(), ra)
    return out.numpy(), act.numpy()


@pytest.mark.parametrize("seed", range(3))
def test_matches_pallas_kernel_shapes(seed, reference):
    """The reference's own kernel-test shapes (tests/test_kernels.py)."""
    rng = np.random.default_rng(seed)
    W, cores = int(rng.integers(2, 16)), int(rng.integers(2, 8))
    _check_against_reference(*_case(rng, W, 6, 96, cores))


def test_matches_pallas_kernel_w1000(reference):
    rng = np.random.default_rng(7)
    _check_against_reference(*_case(rng, 1000, 8, 64, 12))


@pytest.mark.parametrize("seed", range(2))
def test_batched_r3_matches_per_replication(seed, reference):
    rng = np.random.default_rng(100 + seed)
    R, W, F, N, cores = 3, 8, 5, 40, 4
    slots = cores * 8
    active = rng.integers(0, slots, (R, W)).astype(np.int32)
    warm = rng.integers(0, 3, (R, W, F)).astype(np.int32)
    funcs = rng.integers(0, F, (R, N)).astype(np.int32)
    out, act = hermes_select(active, warm, funcs, cores=cores, slots=slots,
                             device="cpu")
    assert out.shape == (R, N) and act.shape == (R, W)
    for r in range(R):
        jo, ja = jax_hermes_select(jnp.asarray(active[r]),
                                   jnp.asarray(warm[r]),
                                   jnp.asarray(funcs[r]), cores=cores,
                                   slots=slots)
        np.testing.assert_array_equal(out[r].numpy(), np.asarray(jo))
        np.testing.assert_array_equal(act[r].numpy(), np.asarray(ja))


def test_all_workers_full_rejects_everything(reference):
    W, F, N, cores, slots = 6, 4, 10, 3, 24
    active = np.full(W, slots, np.int32)
    warm = np.ones((W, F), np.int32)
    funcs = np.arange(N, dtype=np.int32) % F
    out, act = _check_against_reference(active, warm, funcs, cores, slots)
    assert (out == -1).all() and (act == slots).all()


def test_no_free_core_uses_least_loaded_mode(reference):
    rng = np.random.default_rng(3)
    # every worker at or above its core count: high-load mode throughout
    case = _case(rng, 7, 5, 30, cores=4, lo=4, hi=20)
    out, _ = _check_against_reference(*case)
    assert (out >= 0).all()


def test_ties_take_the_lowest_index(reference):
    W, F, N, cores, slots = 8, 3, 12, 4, 32
    active = np.full(W, 2, np.int32)        # every score equal
    warm = np.zeros((W, F), np.int32)
    funcs = np.zeros(N, np.int32)
    out, _ = _check_against_reference(active, warm, funcs, cores, slots)
    assert out[0] == 0


def test_plain_version_takes_unbatched_inputs():
    rng = np.random.default_rng(11)
    active, warm, funcs, cores, slots = _case(rng, 5, 4, 20, 3)
    cols = torch.as_tensor(warm.T[funcs])
    o1, a1 = hermes_select_ref(torch.as_tensor(active), cols, cores=cores,
                               slots=slots)
    o2, a2 = hermes_select_ref(torch.as_tensor(active)[None], cols[None],
                               cores=cores, slots=slots)
    assert torch.equal(o1, o2[0]) and torch.equal(a1, a2[0])


def test_cpu_tensors_take_the_plain_version_and_launch_nothing():
    from repro_torch.kernels.hermes_select import kernel, ops
    rng = np.random.default_rng(12)
    active = torch.as_tensor(rng.integers(0, 16, (2, 6)).astype(np.int32))
    cols = torch.as_tensor(rng.integers(0, 3, (2, 9, 6)).astype(np.int32))
    before = kernel.hermes_select_batch.launches
    got = ops.hermes_select_batch(active, cols, cores=2, slots=16)
    want = hermes_select_ref(active, cols, cores=2, slots=16)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert kernel.hermes_select_batch.launches == before
    # the kernel's wrapper itself refuses CPU tensors: no silent fallback
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernel.hermes_select_batch(active, cols, cores=2, slots=16)


def test_cuda_kernel_matches_plain_version():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from repro_torch.kernels.hermes_select import kernel
    rng = np.random.default_rng(5)
    for R, W, N in ((1, 100, 1), (8, 1000, 256), (3, 7, 50)):
        cores = 12
        slots = cores * 8
        active = torch.as_tensor(
            rng.integers(0, slots + 1, (R, W)).astype(np.int32))
        cols = torch.as_tensor(rng.integers(0, 3, (R, N, W)).astype(np.int32))
        ro, ra = hermes_select_ref(active, cols, cores=cores, slots=slots)
        ko, ka = kernel.hermes_select_batch(
            active.cuda(), cols.cuda(), cores=cores, slots=slots)
        torch.cuda.synchronize()
        assert torch.equal(ko.cpu(), ro) and torch.equal(ka.cpu(), ra)
