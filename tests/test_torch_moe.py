"""The port's MoE (``repro_torch.models.moe``) against the JAX package's
``repro.models.moe`` on the smoke configs of dbrx-132b (4 experts, top
2) and deepseek-v2-236b (8 experts, top 2, one shared expert), on the
CPU.

Layer 0's MoE parameters come from the reference's own ``init`` and are
carried across with ``params_from_reference`` (both configs keep their
published bf16 parameters); the tokens are drawn with numpy.  The same
bf16 or f32 tokens go into both sides, so the router sees the same
values: its choices must be equal.  Tolerances as in
``tests/test_torch_models.py``: f32 1e-4, bf16 6e-2.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import moe as jmoe
from repro.models.transformer import build_model as jbuild_model
from repro_torch import configs
from repro_torch.convert import params_from_reference
from repro_torch.models import moe
from repro_torch.models.transformer import build_model

F32 = {"rtol": 1e-4, "atol": 1e-4}
BF16 = {"rtol": 6e-2, "atol": 6e-2}
MOE_ARCHS = ("dbrx-132b", "deepseek-v2-236b")
DTYPES = ("float32", "bfloat16")


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


@pytest.fixture(scope="module", params=MOE_ARCHS)
def case(request):
    """(name, reference cfg, port cfg, reference layer-0 MoE params, the
    port's) at ``dtype="float32"``; a test replaces the dtype."""
    name = request.param
    jcfg = dataclasses.replace(jconfigs.get_smoke(name), dtype="float32")
    tcfg = dataclasses.replace(configs.get_smoke(name), dtype="float32")
    tree = jax.tree.map(np.asarray,
                        jbuild_model(jcfg).init(jax.random.key(7)))
    jp = jax.tree.map(lambda a: jnp.asarray(a[0]), tree["layers"]["mlp"])
    tp = params_from_reference(tcfg, tree, device="cpu")["layers"][0]["mlp"]
    return name, jcfg, tcfg, jp, tp


def _with_dtype(case, dtype):
    name, jcfg, tcfg, jp, tp = case
    return (dataclasses.replace(jcfg, dtype=dtype),
            dataclasses.replace(tcfg, dtype=dtype), jp, tp)


def _tokens(jcfg, tcfg, shape, seed):
    x = np.random.default_rng(seed).standard_normal(
        (*shape, tcfg.d_model), np.float32)
    return jnp.asarray(x, jcfg.act_dtype), torch.from_numpy(x).to(
        tcfg.act_dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_router_matches_reference(case, dtype):
    """Gates, expert indices (equal) and the aux plus z-loss."""
    jcfg, tcfg, jp, tp = _with_dtype(case, dtype)
    tol = F32 if dtype == "float32" else BF16
    jx, tx = _tokens(jcfg, tcfg, (37,), seed=1)
    jg, ji, ja = jmoe._router(jcfg, jp, jx)
    tg, ti, ta = moe._router(tcfg, tp, tx)
    assert ti.shape == ji.shape == (37, tcfg.moe.top_k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert tg.dtype == tcfg.act_dtype and ta.dtype == torch.float32
    np.testing.assert_allclose(_np(tg), _np(jg), **tol)
    np.testing.assert_allclose(float(ta), float(ja), **F32)
    # the gates are renormalised over the top k
    np.testing.assert_allclose(_np(tg).sum(-1), 1.0, **tol)


def test_aux_loss_terms(case):
    """The Switch aux and the z-loss separately: zero router weights give
    uniform probabilities, so the aux is ``aux_coef`` exactly and the
    z-loss ``router_z_coef · log(E)²``."""
    _, jcfg, tcfg, jp, tp = case
    e = tcfg.moe
    zero = dict(tp, router=torch.zeros_like(tp["router"]))
    jzero = dict(jp, router=jnp.zeros_like(jp["router"]))
    jx, tx = _tokens(jcfg, tcfg, (16,), seed=2)
    _, _, ta = moe._router(tcfg, zero, tx)
    _, _, ja = jmoe._router(jcfg, jzero, jx)
    want = e.aux_coef + e.router_z_coef * np.log(e.n_experts) ** 2
    np.testing.assert_allclose(float(ta), want, rtol=1e-6)
    np.testing.assert_allclose(float(ta), float(ja), rtol=1e-6)


@pytest.mark.parametrize("dtype", DTYPES)
def test_moe_dense_matches_reference(case, dtype):
    jcfg, tcfg, jp, tp = _with_dtype(case, dtype)
    tol = F32 if dtype == "float32" else BF16
    jx, tx = _tokens(jcfg, tcfg, (2, 11), seed=3)
    jy, ja = jmoe.moe_dense(jcfg, jp, jx)
    ty, ta = moe.moe_dense(tcfg, tp, tx)
    assert ty.shape == (2, 11, tcfg.d_model) and ty.dtype == tcfg.act_dtype
    np.testing.assert_allclose(_np(ty), _np(jy), **tol)
    np.testing.assert_allclose(float(ta), float(ja), **F32)


@pytest.mark.parametrize("side", ["below", "at"])
def test_moe_dispatch_at_both_sides_of_the_switch(case, side):
    """``moe`` takes the dense path below ``4 × n_experts`` tokens and the
    expert-parallel one from there; without a sharding context both are
    the dense path, in the reference and here.  ``moe_ep`` is checked
    against the reference's on the same tokens, and ``decode=True``
    against ``moe_dense``."""
    _, jcfg, tcfg, jp, tp = case
    T = 4 * tcfg.moe.n_experts - (1 if side == "below" else 0)
    jx, tx = _tokens(jcfg, tcfg, (1, T), seed=4)
    jy, ja = jmoe.moe(jcfg, jp, jx)
    ty, ta = moe.moe(tcfg, tp, tx)
    np.testing.assert_allclose(_np(ty), _np(jy), **F32)
    np.testing.assert_allclose(float(ta), float(ja), **F32)
    ey, ea = moe.moe_ep(tcfg, tp, tx)
    jey, jea = jmoe.moe_ep(jcfg, jp, jx)
    np.testing.assert_allclose(_np(ey), _np(jey), **F32)
    torch.testing.assert_close(ey, ty, rtol=0, atol=0)
    dy, da = moe.moe(tcfg, tp, tx, decode=True)
    torch.testing.assert_close(dy, moe.moe_dense(tcfg, tp, tx)[0],
                               rtol=0, atol=0)


@pytest.mark.parametrize("dtype", DTYPES)
def test_shared_experts(case, dtype):
    """deepseek's always-on shared expert against the reference's, and its
    part of ``moe_dense``'s output (dbrx has none)."""
    name, jcfg, tcfg, jp, tp = (case[0], *_with_dtype(case, dtype))
    tol = F32 if dtype == "float32" else BF16
    jx, tx = _tokens(jcfg, tcfg, (2, 5), seed=5)
    if tcfg.moe.n_shared == 0:
        assert "shared" not in tp and "shared" not in jp
        return
    np.testing.assert_allclose(_np(moe._shared_mlp(tcfg, tp, tx)),
                               _np(jmoe._shared_mlp(jcfg, jp, jx)), **tol)
    routed = dict(tp)
    del routed["shared"]
    no_shared = dataclasses.replace(
        tcfg, moe=dataclasses.replace(tcfg.moe, n_shared=0))
    if dtype == "float32":
        torch.testing.assert_close(
            moe.moe_dense(tcfg, tp, tx)[0],
            moe.moe_dense(no_shared, routed, tx)[0]
            + moe._shared_mlp(tcfg, tp, tx), rtol=0, atol=0)


@pytest.mark.parametrize("kind", ["swiglu", "geglu"])
def test_activation_matches_reference(kind):
    cfg = dataclasses.replace(configs.get_smoke("dbrx-132b"), mlp=kind)
    jcfg = dataclasses.replace(jconfigs.get_smoke("dbrx-132b"), mlp=kind)
    rng = np.random.default_rng(6)
    g, h = (rng.standard_normal((3, 7, 16), np.float32) for _ in range(2))
    np.testing.assert_allclose(
        _np(moe._act(cfg, torch.from_numpy(g), torch.from_numpy(h))),
        _np(jmoe._act(jcfg, jnp.asarray(g), jnp.asarray(h))), **F32)


def test_init_moe_shapes_and_law(case):
    """The port's own init: the reference's tree, shapes and dtypes;
    weights ~ N(0, 1/fan_in) with fan-in the contraction dim (``D`` for
    ``w_gate``/``w_in``, ``F`` for ``w_out``)."""
    _, jcfg, tcfg, jp, tp = case
    big = dataclasses.replace(tcfg, d_model=256, moe=dataclasses.replace(
        tcfg.moe, d_ff_expert=256))
    p = moe.init_moe(torch.Generator().manual_seed(0), big)
    ref = jmoe.init_moe(jax.random.key(0), dataclasses.replace(
        jcfg, d_model=256, moe=dataclasses.replace(jcfg.moe,
                                                   d_ff_expert=256)))
    assert jax.tree.structure(jax.tree.map(lambda x: 0, ref)) == \
        jax.tree.structure(jax.tree.map(lambda x: 0, p))
    for a, b in zip(jax.tree.leaves(ref), jax.tree.leaves(p)):
        assert tuple(b.shape) == a.shape and b.dtype == torch.bfloat16
    for key in ("w_gate", "w_in", "w_out", "router"):
        w = p[key].float()
        assert abs(float(w.std()) * np.sqrt(256) - 1) < 0.05, key


def test_moe_block_routes_through_moe(case, monkeypatch):
    """The whole model runs the MoE in every layer: forward's ``aux`` is
    the sum of the layers' router losses, and a decode step routes one
    token a layer."""
    name, jcfg, tcfg, jp, tp = case
    model = build_model(tcfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(1))
    seen = []
    real = moe._router

    def spy(cfg, p, xf):
        out = real(cfg, p, xf)
        seen.append((xf.shape[0], out[2]))
        return out

    monkeypatch.setattr(moe, "_router", spy)
    toks = torch.from_numpy(np.random.default_rng(8).integers(
        0, tcfg.vocab, (1, 6)))
    _, aux = model.forward(params, toks)
    assert [n for n, _ in seen] == [6] * tcfg.n_layers
    total = torch.zeros((), dtype=torch.float32)
    for _, a in seen:
        total = total + a
    assert float(aux) == float(total) > 0
    seen.clear()
    model.decode_step(params, toks[:, :1], model.init_cache(1, 8),
                      torch.zeros(1, dtype=torch.int32))
    assert [n for n, _ in seen] == [1] * tcfg.n_layers
