"""Gradients through the port's forward, its kernels' entry points and the
attention kernels' refusal.

* every family back-propagates: the recurrent stacks carry their state
  functionally in ``forward`` and ``loss`` and write a caller's cache in
  place only in ``prefill`` and ``decode_step``;
* ``ops.wkv6`` and ``ops.ssd`` under autograd are
  :class:`~repro_torch.kernels.autograd.ScanGrad`: its gradient passes
  ``torch.autograd.gradcheck`` in f64 and equals autograd through the
  plain chunked form bit for bit on the CPU;
* under ``attn_impl="pallas"`` a gradient is refused, as the reference's
  ``jax.grad`` through its flash kernel refuses one.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import transformer as jtr
from repro_torch import configs
from repro_torch.kernels.autograd import ScanGrad
from repro_torch.kernels.decode_attention import ops as d_ops
from repro_torch.kernels.flash_attention import ops as f_ops
from repro_torch.kernels.mamba2_ssd import ops as s_ops
from repro_torch.kernels.mamba2_ssd.ref import ssd_chunked_ref
from repro_torch.kernels.rwkv6_wkv import kernel as wk
from repro_torch.kernels.rwkv6_wkv import ops as w_ops
from repro_torch.kernels.rwkv6_wkv.ref import wkv6_chunked_ref
from repro_torch.models import transformer as tr

CHUNK = 4
T_TINY = 2 * CHUNK + 3            # two whole chunks and a ragged tail


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """Smoke-size ops run fastest on one thread, and the test workers
    share the host's cores (several threads each slowed a step ~5×)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _requiring_grad(params):
    if isinstance(params, dict):
        return {k: _requiring_grad(v) for k, v in params.items()}
    if isinstance(params, list):
        return [_requiring_grad(v) for v in params]
    return params.detach().requires_grad_()


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


# ---------------------------------------------------------------------------
# every family back-propagates
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", configs.ARCH_NAMES)
def test_loss_backward_every_arch(arch):
    """``loss.backward()`` on the smoke config as it is (its dtypes, its
    remat): every parameter the loss reads gets a finite gradient."""
    cfg = configs.get_smoke(arch)
    model = tr.build_model(cfg, "cpu")
    params = _requiring_grad(model.init(torch.Generator().manual_seed(0)))
    toks = torch.randint(0, cfg.vocab, (2, 24),
                         generator=torch.Generator().manual_seed(1))
    loss = model.loss(params, toks, torch.roll(toks, -1, 1))
    loss.backward()
    grads = [p.grad for p in _leaves(params) if p.numel()]
    assert sum(g is not None for g in grads) >= len(grads) - 1
    for g in grads:
        assert g is None or torch.isfinite(g.float()).all()
    assert any(p.grad is not None and p.grad.abs().sum() > 0
               for p in _leaves(params["layers"][0]))


@pytest.mark.parametrize("arch", ["rwkv6-3b", "zamba2-2.7b"])
def test_serving_still_writes_the_cache_in_place(arch):
    """``prefill`` and ``decode_step`` advance the caller's cache in place
    and return it; ``forward`` allocates its own zero state."""
    cfg = dataclasses.replace(configs.get_smoke(arch), dtype="float32")
    model = tr.build_model(cfg, "cpu")
    params = model.init(torch.Generator().manual_seed(0))
    toks = torch.randint(0, cfg.vocab, (1, 12),
                         generator=torch.Generator().manual_seed(2))
    cache = model.init_cache(1, 16)
    before = {k: v.clone() for k, v in cache.items()}
    ptrs = {k: v.data_ptr() for k, v in cache.items()}
    _, out = model.prefill(params, toks[:, :10], cache)
    assert out is cache and {k: v.data_ptr() for k, v in out.items()} == ptrs
    changed = {k for k in cache if not torch.equal(cache[k], before[k])}
    assert changed == set(cache)
    state = {k: v.clone() for k, v in cache.items()}
    model.decode_step(params, toks[:, 10:11], cache,
                      torch.tensor([10], dtype=torch.int32))
    assert all(not torch.equal(cache[k], state[k]) for k in
               ("wkv", "tm_shift") if k in cache)
    # the full forward from its own zero state, prefill from a fresh cache
    logits, _ = model.forward(params, toks[:, :10])
    last, _ = model.prefill(params, toks[:, :10], model.init_cache(1, 16))
    torch.testing.assert_close(last[:, 0], logits[:, -1], rtol=1e-5,
                               atol=1e-5)


# ---------------------------------------------------------------------------
# the scans' gradient
# ---------------------------------------------------------------------------

def _wkv_inputs(dtype, seed=0, B=1, H=2, K=4):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, T_TINY, H, K)) * 0.5
               for _ in range(3))
    lw = -np.exp(rng.standard_normal((B, T_TINY, H, K)) * 0.5 - 1.0)
    u = rng.standard_normal((H, K)) * 0.3
    s0 = rng.standard_normal((B, H, K, K)) * 0.2
    return [torch.tensor(a, dtype=dtype, requires_grad=True)
            for a in (r, k, v, lw, u, s0)]


def _ssd_inputs(dtype, seed=0, B=1, H=2, P=4, N=8):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T_TINY, H, P))
    dt = np.log1p(np.exp(rng.standard_normal((B, T_TINY, H)) * 0.5))
    bmat, cmat = (rng.standard_normal((B, T_TINY, N)) * 0.5
                  for _ in range(2))
    a = -np.exp(rng.standard_normal(H) * 0.3)
    h0 = rng.standard_normal((B, H, P, N)) * 0.2
    return [torch.tensor(z, dtype=dtype, requires_grad=True)
            for z in (x, dt, bmat, cmat, a, h0)]


SCANS = {"wkv6": (wkv6_chunked_ref, _wkv_inputs, w_ops.wkv6),
         "ssd": (ssd_chunked_ref, _ssd_inputs, s_ops.ssd)}


@pytest.mark.parametrize("scan", SCANS)
def test_scan_grad_gradcheck_f64(scan):
    plain, inputs, _ = SCANS[scan]
    assert torch.autograd.gradcheck(
        lambda *xs: ScanGrad.apply(plain, plain, CHUNK, *xs),
        inputs(torch.float64), eps=1e-6, atol=1e-7, rtol=1e-5)


@pytest.mark.parametrize("carry", [True, False])
@pytest.mark.parametrize("scan", SCANS)
def test_scan_grad_equals_autograd_through_plain_form(scan, carry):
    """f32, through the entry point (which takes ``ScanGrad`` once an
    input requires a gradient): every input's gradient bit for bit."""
    plain, inputs, op = SCANS[scan]
    xs = inputs(torch.float32, seed=3)
    if not carry:
        xs[-1] = None
    rng = np.random.default_rng(4)
    outs = op(*xs, chunk=CHUNK)
    assert outs[0].grad_fn is not None
    assert type(outs[0].grad_fn).__name__ == "ScanGradBackward"
    cots = [torch.from_numpy(rng.standard_normal(o.shape).astype(np.float32))
            for o in outs]
    wrt = [x for x in xs if x is not None]
    got = torch.autograd.grad(outs, wrt, cots)
    direct = torch.autograd.grad(plain(*xs, chunk=CHUNK), wrt, cots)
    for g, d in zip(got, direct):
        assert torch.equal(g, d)
    with torch.no_grad():
        plain_out = op(*xs, chunk=CHUNK)
    assert plain_out[0].grad_fn is None
    for a, b in zip(plain_out, outs):
        assert torch.equal(a, b.detach())


def test_scan_grad_on_the_card():
    """On the card the forward is the kernel (one launch a call, counted)
    and the gradient the plain form's on the same inputs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; python3 chip_smoke.py runs the "
                    "training path there")
    rng = np.random.default_rng(5)
    B, T, H, K = 1, 77, 2, 64
    r, k, v = (torch.tensor(rng.standard_normal((B, T, H, K)) * 0.5,
                            dtype=torch.float32, device="cuda",
                            requires_grad=True) for _ in range(3))
    lw = torch.tensor(-np.exp(rng.standard_normal((B, T, H, K)) - 1.0),
                      dtype=torch.float32, device="cuda", requires_grad=True)
    u = torch.zeros((H, K), device="cuda", requires_grad=True)
    before = wk.wkv6.launches
    y, s = w_ops.wkv6(r, k, v, lw, u, None, chunk=32)
    assert wk.wkv6.launches == before + 1
    got = torch.autograd.grad((y.sum() + s.sum()), (r, k, v, lw, u))
    y2, s2 = wkv6_chunked_ref(r, k, v, lw, u, None, chunk=32)
    want = torch.autograd.grad((y2.sum() + s2.sum()), (r, k, v, lw, u))
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# the attention kernels refuse a gradient
# ---------------------------------------------------------------------------

def test_pallas_attention_refuses_a_gradient_like_the_reference():
    tcfg = dataclasses.replace(configs.get_smoke("olmo-1b"),
                               attn_impl="pallas", dtype="float32")
    jcfg = dataclasses.replace(jconfigs.get_smoke("olmo-1b"),
                               attn_impl="pallas", dtype="float32")
    toks = np.random.default_rng(6).integers(0, tcfg.vocab, (1, 16),
                                             dtype=np.int32)
    labels = np.roll(toks, -1, 1)
    jmodel = jtr.build_model(jcfg)
    jparams = jmodel.init(jax.random.key(0))
    with pytest.raises(AssertionError):
        jax.grad(jmodel.loss)(jparams, jnp.asarray(toks),
                              jnp.asarray(labels))
    model = tr.build_model(tcfg, "cpu")
    params = model.init(torch.Generator().manual_seed(0))
    t, lab = torch.from_numpy(toks), torch.from_numpy(labels)
    with pytest.raises(NotImplementedError, match="xla_chunked"):
        model.loss(_requiring_grad(params), t, lab).backward()
    # serving is unaffected: no parameter requires a gradient, or no grad
    model.loss(params, t, lab)
    with torch.no_grad():
        model.loss(_requiring_grad(params), t, lab)


def test_attention_ops_refuse_a_gradient():
    q = torch.zeros((1, 8, 2, 32), requires_grad=True)
    kv = torch.zeros((1, 8, 2, 32))
    with pytest.raises(NotImplementedError, match="xla_chunked"):
        f_ops.flash_attention(q, kv, kv)
    with pytest.raises(NotImplementedError, match="xla_chunked"):
        d_ops.decode_attention(q[:, 0], kv, kv,
                               torch.tensor([3], dtype=torch.int32))
    with torch.no_grad():
        assert f_ops.flash_attention(q, kv, kv).shape == q.shape
