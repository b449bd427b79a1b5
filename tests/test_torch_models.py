"""Port model modules against the JAX package on the smoke configs.

Parameters come from the reference's own ``init`` and are carried across
with ``repro_torch.convert.params_from_reference``; inputs are drawn with
numpy.  Tolerances:

* f32: 1e-4 (relative and absolute) — the same f32 math in another
  summation order across frameworks;
* bf16: ``tests/test_models.py:172-173``'s 6e-2 — bf16 rounds at other
  places in the two frameworks.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models.transformer import build_model as jbuild_model
from repro_torch import NotPortedError, configs
from repro_torch.convert import params_from_reference
from repro_torch.models import attention as attn
from repro_torch.models import layers
from repro_torch.models.common import ModelCfg
from repro_torch.models.transformer import build_model

F32 = {"rtol": 1e-4, "atol": 1e-4}
BF16 = {"rtol": 6e-2, "atol": 6e-2}
ATTN_ARCHS = ("qwen3-14b", "granite-20b", "olmo-1b", "musicgen-large")
SERVED = ("olmo-1b", "musicgen-large")


def _cfgs(name, impl="pallas", dtype="float32"):
    j = dataclasses.replace(jconfigs.get_smoke(name), attn_impl=impl,
                            dtype=dtype)
    t = dataclasses.replace(configs.get_smoke(name), attn_impl=impl,
                            dtype=dtype)
    return j, t


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _ref_params(jcfg, seed=0):
    jp = jbuild_model(jcfg).init(jax.random.key(seed))
    return jp, jax.tree.map(np.asarray, jp)


def params_to_reference(params):
    """The port's parameters back as the reference's tree of numpy arrays
    (layers stacked on a leading ``L`` axis)."""
    layers = [jax.tree.map(lambda x: x.numpy(), p) for p in params["layers"]]
    return {"embed": jax.tree.map(lambda x: x.numpy(), params["embed"]),
            "layers": jax.tree.map(lambda *xs: np.stack(xs), *layers),
            "final_norm": params["final_norm"].numpy()}


def _layer0(tree):
    return jax.tree.map(lambda a: a[0], tree["layers"])


@pytest.fixture(scope="module", params=SERVED)
def served(request):
    jcfg, tcfg = _cfgs(request.param)
    jp, tree = _ref_params(jcfg)
    return request.param, jcfg, tcfg, jp, tree


# ---------------------------------------------------------------------------
# configs and params
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", jconfigs.ARCH_NAMES)
def test_configs_port_unchanged(name):
    for get in ("get", "get_smoke"):
        j, t = getattr(jconfigs, get)(name), getattr(configs, get)(name)
        assert isinstance(t, ModelCfg)
        jd, td = dataclasses.asdict(j), dataclasses.asdict(t)
        assert jd == td
        assert t.n_params() == j.n_params()
        assert t.active_params() == j.active_params()
        assert str(t.act_dtype).split(".")[-1] == str(j.act_dtype)
        assert str(t.p_dtype).split(".")[-1] == str(j.p_dtype)


def test_params_round_trip_bit_for_bit(served):
    name, jcfg, tcfg, jp, tree = served
    params = params_from_reference(tcfg, tree, device="cpu")
    assert len(params["layers"]) == tcfg.n_layers
    back = params_to_reference(params)
    flat, tdef = jax.tree.flatten(tree)
    flat2, tdef2 = jax.tree.flatten(back)
    assert tdef == tdef2
    for a, b in zip(flat, flat2):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a.view(np.uint32) if a.size else a,
                                      b.view(np.uint32) if b.size else b)
    for i, p_l in enumerate(params["layers"]):
        np.testing.assert_array_equal(p_l["attn"]["wq"].numpy(),
                                      tree["layers"]["attn"]["wq"][i])
    with pytest.raises(ValueError, match="leading L"):
        params_from_reference(dataclasses.replace(tcfg, n_layers=3), tree,
                              device="cpu")


def test_port_init_matches_reference_shapes_and_law(served):
    """The port's own init: the reference's tree structure, shapes and
    dtypes; dense weights ~ N(0, 1/fan_in), embeddings ~ N(0, 0.02²)."""
    name, jcfg, tcfg, jp, tree = served
    model = build_model(tcfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    back = params_to_reference(params)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        # the reference's empty final_norm (LayerNorm without scale) takes
        # JAX's default float, which follows the process-wide x64 flag
        assert a.shape == b.shape and (a.dtype == b.dtype or a.size == 0)
    wq = params["layers"][0]["attn"]["wq"]
    assert abs(float(wq.std()) * np.sqrt(tcfg.d_model) - 1) < 0.05
    assert abs(float(params["embed"]["tok"].std()) / 0.02 - 1) < 0.05


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layers_match_reference(dtype):
    tol = F32 if dtype == "float32" else BF16
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 9, 4, 32), np.float32)
    scale = rng.standard_normal(32).astype(np.float32) * 0.1
    tx, jx = torch.from_numpy(x).to(tdt), jnp.asarray(x, jdt)
    np.testing.assert_allclose(
        _np(layers.rmsnorm(tx, torch.from_numpy(scale))),
        _np(jlayers.rmsnorm(jx, jnp.asarray(scale))), **tol)
    np.testing.assert_allclose(_np(layers.rmsnorm(tx, None)),
                               _np(jlayers.rmsnorm(jx, None)), **tol)
    np.testing.assert_allclose(_np(layers.layernorm_np(tx)),
                               _np(jlayers.layernorm_np(jx)), **tol)
    pos = np.arange(3, 12)
    for theta in (1e4, 1e6):
        np.testing.assert_allclose(
            _np(layers.apply_rope(tx, torch.from_numpy(pos), theta)),
            _np(jlayers.apply_rope(jx, jnp.asarray(pos), theta)), **tol)
    np.testing.assert_allclose(_np(layers.sinusoidal_pe(777, 128, 5)),
                               _np(jlayers.sinusoidal_pe(777, 128, 5)),
                               **F32)


@pytest.mark.parametrize("kind", ["swiglu", "geglu", "gelu"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlp_embed_logits_match_reference(kind, dtype):
    tol = F32 if dtype == "float32" else BF16
    jcfg = dataclasses.replace(jconfigs.get_smoke("olmo-1b"), mlp=kind,
                               dtype=dtype, tie_embeddings=kind == "gelu",
                               logit_softcap=30.0 if kind == "geglu" else 0.)
    tcfg = dataclasses.replace(configs.get_smoke("olmo-1b"), mlp=kind,
                               dtype=dtype, tie_embeddings=kind == "gelu",
                               logit_softcap=30.0 if kind == "geglu" else 0.)
    key = jax.random.key(1)
    jm = jlayers.init_mlp(key, jcfg)
    je = jlayers.init_embed(key, jcfg)
    tm = params_from_reference(tcfg, {"embed": jax.tree.map(np.asarray, je),
                                      "layers": {}, "final_norm": np.zeros(0)},
                               device="cpu")["embed"]
    tmlp = {k: torch.from_numpy(np.array(v)) for k, v in jm.items()}
    x = np.random.default_rng(2).standard_normal((2, 5, 128), np.float32)
    tx = torch.from_numpy(x).to(tcfg.act_dtype)
    jx = jnp.asarray(x, jcfg.act_dtype)
    np.testing.assert_allclose(_np(layers.mlp(tcfg, tmlp, tx)),
                               _np(jlayers.mlp(jcfg, jm, jx)), **tol)
    np.testing.assert_allclose(_np(layers.lm_logits(tcfg, tm, tx)),
                               _np(jlayers.lm_logits(jcfg, je, jx)), **tol)
    toks = np.random.default_rng(3).integers(0, tcfg.vocab, (2, 7))
    np.testing.assert_array_equal(
        _np(layers.embed(tcfg, tm, torch.from_numpy(toks))),
        _np(jlayers.embed(jcfg, je, jnp.asarray(toks))))


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def _attn_case(name, impl, dtype, S=21):
    jcfg, tcfg = _cfgs(name, impl, dtype)
    _, tree = _ref_params(jcfg, seed=5)
    jp = jax.tree.map(jnp.asarray, _layer0(tree))["attn"]
    tp = params_from_reference(tcfg, tree, device="cpu")["layers"][0]["attn"]
    x = np.random.default_rng(6).standard_normal((2, S, tcfg.d_model),
                                                 np.float32)
    return (jcfg, tcfg, jp, tp, jnp.asarray(x, jcfg.act_dtype),
            torch.from_numpy(x).to(tcfg.act_dtype))


@pytest.mark.parametrize("impl", ["pallas", "naive"])
@pytest.mark.parametrize("name", ATTN_ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sdpa_matches_reference(name, impl, dtype):
    tol = F32 if dtype == "float32" else BF16
    jcfg, tcfg, jp, tp, jx, tx = _attn_case(name, impl, dtype)
    S = tx.shape[1]
    jq, jk, jv = jattn._qkv(jcfg, jp, jx, jnp.arange(S))
    tq, tk, tv = attn._qkv(tcfg, tp, tx, torch.arange(S))
    for a, b in ((tq, jq), (tk, jk), (tv, jv)):
        np.testing.assert_allclose(_np(a), _np(b), **tol)
    # the same q, k, v on both sides isolates the attention itself
    same = [torch.from_numpy(np.array(a, np.float32)).to(tcfg.act_dtype)
            for a in (jq, jk, jv)]
    np.testing.assert_allclose(_np(attn.sdpa(tcfg, *same)),
                               _np(jattn.sdpa(jcfg, jq, jk, jv)), **tol)


@pytest.mark.parametrize("impl", ["pallas", "naive"])
@pytest.mark.parametrize("name", ATTN_ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_append_kv_and_decode_attention_match_reference(name, impl, dtype):
    tol = F32 if dtype == "float32" else BF16
    jcfg, tcfg, jp, tp, jx, tx = _attn_case(name, impl, dtype, S=1)
    B, S_max = 2, 40
    rng = np.random.default_rng(7)
    kc = rng.standard_normal((B, S_max, tcfg.n_kv_heads, tcfg.head_dim),
                             np.float32)
    vc = rng.standard_normal(kc.shape, np.float32)
    pos = np.array([3, 27], np.int32)
    jk, jv = jattn.append_kv(jcfg, jp, jx, jnp.asarray(kc, jcfg.act_dtype),
                             jnp.asarray(vc, jcfg.act_dtype),
                             jnp.asarray(pos))
    tkc = torch.from_numpy(kc).to(tcfg.act_dtype)
    tvc = torch.from_numpy(vc).to(tcfg.act_dtype)
    tpos = torch.from_numpy(pos)
    tk, tv = attn.append_kv(tcfg, tp, tx, tkc, tvc, tpos)
    assert tk is tkc and tv is tvc                     # written in place
    np.testing.assert_allclose(_np(tk), _np(jk), **tol)
    np.testing.assert_allclose(_np(tv), _np(jv), **tol)
    out = attn.decode_attention(tcfg, tp, tx, tk, tv, tpos)
    ref = jattn.decode_attention(jcfg, jp, jx, jk, jv, jnp.asarray(pos))
    assert out.shape == (B, 1, tcfg.d_model)
    np.testing.assert_allclose(_np(out), _np(ref), **tol)


def test_init_kv_cache_matches_reference():
    jcfg, tcfg = _cfgs("qwen3-14b", dtype="bfloat16")
    j = jattn.init_kv_cache(jcfg, 2, 16)
    t = attn.init_kv_cache(tcfg, 2, 16, device="cpu")
    for key in ("k", "v"):
        assert tuple(t[key].shape) == j[key].shape
        assert t[key].dtype == torch.bfloat16 and not t[key].any()


# ---------------------------------------------------------------------------
# the whole model: forward, prefill, decode_step
# ---------------------------------------------------------------------------

def _model_pair(name, dtype, impl="pallas"):
    jcfg, tcfg = _cfgs(name, impl, dtype)
    jp, tree = _ref_params(jcfg)
    return (jbuild_model(jcfg), jp, build_model(tcfg, device="cpu"),
            params_from_reference(tcfg, tree, device="cpu"))


@pytest.mark.parametrize("name", SERVED)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_prefill_decode_match_reference(name, dtype):
    """Prefill a 21-token prompt, then 6 teacher-forced decode steps: the
    prefill logits, every step's logits and the caches against JAX's
    ``build_model`` with ``attn_impl="pallas"``, and the full forward over
    all 27 tokens."""
    tol = F32 if dtype == "float32" else BF16
    jm, jp, tm, tp = _model_pair(name, dtype)
    S, n, max_len = 21, 6, 32
    toks = np.random.default_rng(11).integers(0, tm.cfg.vocab, (1, S + n))
    jl, _ = jax.jit(jm.forward)(jp, jnp.asarray(toks, jnp.int32))
    tl, aux = tm.forward(tp, torch.from_numpy(toks))
    assert float(aux) == 0.0 and tl.dtype == tm.cfg.act_dtype
    np.testing.assert_allclose(_np(tl), _np(jl), **tol)

    jc = jm.init_cache(1, max_len)
    tc = tm.init_cache(1, max_len)
    jlog, jc = jax.jit(jm.prefill)(jp, jnp.asarray(toks[:, :S], jnp.int32),
                                   jc)
    tlog, tc2 = tm.prefill(tp, torch.from_numpy(toks[:, :S]), tc)
    assert tc2 is tc
    np.testing.assert_allclose(_np(tlog), _np(jlog), **tol)
    jdec = jax.jit(jm.decode_step)
    for i in range(n):
        tok = toks[:, S + i:S + i + 1]
        pos = np.array([S + i], np.int32)
        jlog, jc = jdec(jp, jnp.asarray(tok, jnp.int32), jc,
                        jnp.asarray(pos))
        tlog, tc = tm.decode_step(tp, torch.from_numpy(tok), tc,
                                  torch.from_numpy(pos))
        assert tlog.shape == (1, 1, tm.cfg.vocab)
        np.testing.assert_allclose(_np(tlog), _np(jlog), **tol)
        # the step's logits are the full forward's at that position
        np.testing.assert_allclose(_np(tlog[:, 0]), _np(tl[:, S + i]),
                                   **tol)
    np.testing.assert_allclose(_np(tc["k"]), _np(jc["k"]), **tol)
    np.testing.assert_allclose(_np(tc["v"]), _np(jc["v"]), **tol)


@pytest.mark.parametrize("name", SERVED)
def test_pallas_and_naive_paths_agree(name):
    """The kernel path and the plain path over the same parameters."""
    _, _, tm, tp = _model_pair(name, "float32")
    naive = build_model(dataclasses.replace(tm.cfg, attn_impl="naive"),
                        device="cpu")
    toks = torch.from_numpy(
        np.random.default_rng(12).integers(0, tm.cfg.vocab, (2, 19)))
    np.testing.assert_allclose(_np(tm.forward(tp, toks)[0]),
                               _np(naive.forward(tp, toks)[0]), **F32)


def test_gemma_2b_attention_widths_match_reference():
    """gemma-2b at its published attention widths (d 2048, Dh = 256, 8
    query heads on 1 KV head, GeGLU with d_ff 16384), cut to 2 layers and
    a vocab of 512: the port's logits against the reference's
    (``attn_impl="pallas"``, its flash kernel in interpret mode) over the
    same parameters, f32 within 1e-4 × max |logit|; then a prefill and
    two decode steps through the cache against the port's full forward.
    The smoke config (Dh = 64) would not reach Dh = 256."""
    cut = dict(n_layers=2, vocab=512, attn_impl="pallas", dtype="float32")
    jcfg = dataclasses.replace(jconfigs.get("gemma-2b"), **cut)
    tcfg = dataclasses.replace(configs.get("gemma-2b"), **cut)
    assert (tcfg.head_dim, tcfg.n_heads, tcfg.n_kv_heads, tcfg.mlp) == \
        (256, 8, 1, "geglu")
    jp, tree = _ref_params(jcfg, seed=4)
    tm = build_model(tcfg, device="cpu")
    tp = params_from_reference(tcfg, tree, device="cpu")
    S, n = 13, 2
    toks = np.random.default_rng(4).integers(0, tcfg.vocab, (1, S + n))
    jl, _ = jax.jit(jbuild_model(jcfg).forward)(jp, jnp.asarray(toks,
                                                                jnp.int32))
    tl, _ = tm.forward(tp, torch.from_numpy(toks))
    want = _np(jl)
    scale = float(np.abs(want).max())
    assert float(np.abs(_np(tl) - want).max()) <= 1e-4 * scale
    cache = tm.init_cache(1, 32)
    logits, cache = tm.prefill(tp, torch.from_numpy(toks[:, :S]), cache)
    got = [logits]
    for i in range(S, S + n):
        logits, cache = tm.decode_step(
            tp, torch.from_numpy(toks[:, i:i + 1]), cache,
            torch.tensor([i], dtype=torch.int32))
        got.append(logits)
    got = _np(torch.cat(got, dim=1))
    assert float(np.abs(got - want[:, S - 1:]).max()) <= 1e-4 * scale


def test_not_ported_parts_raise():
    """Nothing that used to raise here does any more: the MoE and MLA
    families (dbrx-132b, deepseek-v2-236b) and the ``xla_chunked`` and
    ``xla_unrolled`` impls build and run on the CPU, and rwkv6 (no
    attention) runs under its default impl.  An impl the port does not
    know still raises."""
    for name in ("dbrx-132b", "deepseek-v2-236b"):       # moe, mla blocks
        cfg = configs.get_smoke(name)
        assert cfg.attn_impl == "xla_chunked" and cfg.moe is not None
        model = build_model(cfg, device="cpu")
        params = model.init(torch.Generator().manual_seed(0))
        logits, aux = model.forward(params, torch.zeros((1, 5),
                                                        dtype=torch.long))
        assert logits.shape == (1, 5, cfg.vocab) and float(aux) > 0
        assert bool(logits.isfinite().all())
    rwkv = configs.get_smoke("rwkv6-3b")
    assert rwkv.attn_impl == "xla_chunked"
    assert build_model(rwkv, device="cpu").cfg is rwkv
    for impl in ("xla_chunked", "xla_unrolled"):
        cfg = dataclasses.replace(configs.get_smoke("olmo-1b"),
                                  attn_impl=impl, attn_chunk=4)
        assert build_model(cfg, device="cpu").cfg is cfg
        q = torch.zeros(1, 8, 4, 32)
        assert attn.sdpa(cfg, q, q, q).shape == q.shape
    cfg = dataclasses.replace(configs.get_smoke("olmo-1b"), attn_impl="flash")
    with pytest.raises(NotPortedError, match="flash"):
        build_model(cfg, device="cpu")
