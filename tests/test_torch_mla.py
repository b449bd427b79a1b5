"""MLA (DeepSeek-V2's latent attention) and the MoE families' whole
models in the port against the JAX package, on the CPU.

* MLA's pieces on deepseek-v2-236b's smoke config (4 heads, q_lora 64,
  kv_lora 32, qk_nope 32, qk_rope 16, v_dim 32): ``init_mla``'s shapes
  and law, ``_mla_qkv``, ``mla_attention`` under every ``attn_impl`` (the
  chunked and unrolled loops with S > ``attn_chunk``), ``_sdpa_chunked_vd``
  and ``_sdpa_unrolled_vd``, the latent cache, ``mla_append_kv`` and the
  absorbed ``mla_decode``.
* The whole model for both MoE families (dbrx-132b: GQA and MoE;
  deepseek-v2-236b: MLA, MoE and a shared expert): ``forward`` (with its
  ``aux``), prefill plus teacher-forced decode steps, and ``loss``, with
  the reference's parameters carried across bit for bit (a round trip
  checks that).

Tolerances as in ``tests/test_torch_models.py``: f32 1e-4, bf16 6e-2.
The router's choices are recorded on both sides.  In f32 they must be
equal.  In bf16 the two frameworks round the router's input at other
places, and a (token, layer) whose top-k boundary is a near tie can pick
another expert: that token's logits then differ by far more than bf16
rounding (deepseek's smoke model, seed 0 weights, shows such flips at
layer 1).  The bf16 checks therefore hold the router logits of every
token and layer to 6e-2 × their max |value| (so a flip is a near tie of
the rounding, not a fault; a token is left out of the layers after its
first flip, whose input the flip changed), every compared position whose choices agree
in every layer to 6e-2 × max |logit|, and count the flipped ones (at most a tenth of
the forward's tokens, and of the prefill's and decode steps' compared
positions); see ROADMAP Queue 3.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import attention as jattn
from repro.models import moe as jmoe
from repro.models.transformer import build_model as jbuild_model
from repro_torch import configs
from repro_torch.convert import params_from_reference
from repro_torch.models import attention as attn
from repro_torch.models import moe
from repro_torch.models.transformer import build_model

F32 = {"rtol": 1e-4, "atol": 1e-4}
BF16 = {"rtol": 6e-2, "atol": 6e-2}
DTYPES = ("float32", "bfloat16")
IMPLS = ("naive", "pallas", "xla_chunked", "xla_unrolled")
MOE_ARCHS = ("dbrx-132b", "deepseek-v2-236b")


def _cfgs(name, dtype="float32", impl="xla_chunked", chunk=4):
    return tuple(dataclasses.replace(c.get_smoke(name), dtype=dtype,
                                     attn_impl=impl, attn_chunk=chunk)
                 for c in (jconfigs, configs))


def _tol(dtype):
    return F32 if dtype == "float32" else BF16


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _pair(jcfg, tcfg, shape, seed):
    """The same numpy draw as a JAX and a torch tensor in act dtype."""
    x = np.random.default_rng(seed).standard_normal(shape, np.float32)
    return jnp.asarray(x, jcfg.act_dtype), torch.from_numpy(x).to(
        tcfg.act_dtype)


@pytest.fixture(scope="module")
def mla_tree():
    jcfg, _ = _cfgs("deepseek-v2-236b")
    return jax.tree.map(np.asarray, jbuild_model(jcfg).init(
        jax.random.key(5)))


def _mla_case(tree, dtype="float32", impl="xla_chunked", chunk=4):
    jcfg, tcfg = _cfgs("deepseek-v2-236b", dtype, impl, chunk)
    jp = jax.tree.map(lambda a: jnp.asarray(a[0]), tree["layers"]["attn"])
    tp = params_from_reference(tcfg, tree, device="cpu")["layers"][0]["attn"]
    return jcfg, tcfg, jp, tp


# ---------------------------------------------------------------------------
# MLA pieces
# ---------------------------------------------------------------------------

def test_init_mla_shapes_and_law():
    """The port's own ``init_mla``: the reference's keys, shapes and
    dtypes; zero norm scales; weights ~ N(0, 1/fan_in)."""
    jcfg, tcfg = _cfgs("deepseek-v2-236b")
    wide = dict(d_model=512, mla=dataclasses.replace(tcfg.mla, q_lora=256,
                                                     kv_lora=256))
    ref = jattn.init_mla(jax.random.key(0),
                         dataclasses.replace(jcfg, **wide))
    p = attn.init_mla(torch.Generator().manual_seed(0),
                      dataclasses.replace(tcfg, **wide))
    assert list(p) == list(ref)
    for key, a in ref.items():
        assert tuple(p[key].shape) == a.shape, key
        assert p[key].dtype == torch.bfloat16
    assert not p["q_a_norm"].any() and not p["kv_a_norm"].any()
    for key in ("wq_a", "wq_b", "wkv_a", "wk_b", "wv_b", "wo"):
        w = p[key].float()
        assert abs(float(w.std()) * np.sqrt(w.shape[0]) - 1) < 0.05, key


@pytest.mark.parametrize("dtype", DTYPES)
def test_mla_qkv_matches_reference(mla_tree, dtype):
    jcfg, tcfg, jp, tp = _mla_case(mla_tree, dtype)
    jx, tx = _pair(jcfg, tcfg, (2, 9, tcfg.d_model), seed=1)
    pos = np.arange(3, 12)
    jq, jk, jv, (jc, jr) = jattn._mla_qkv(jcfg, jp, jx, jnp.asarray(pos))
    tq, tk, tv, (tc, tr) = attn._mla_qkv(tcfg, tp, tx, torch.from_numpy(pos))
    for got, want in ((tq, jq), (tk, jk), (tv, jv), (tc, jc), (tr, jr)):
        assert tuple(got.shape) == want.shape and got.dtype == tcfg.act_dtype
        np.testing.assert_allclose(_np(got), _np(want), **_tol(dtype))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("impl", IMPLS)
def test_mla_attention_matches_reference(mla_tree, impl, dtype):
    """48 tokens over ``attn_chunk`` 4: the chunked loop in blocks of 4,
    the unrolled one in blocks of 6; ``naive`` and ``pallas`` the full
    score matrix."""
    jcfg, tcfg, jp, tp = _mla_case(mla_tree, dtype, impl)
    jx, tx = _pair(jcfg, tcfg, (2, 48, tcfg.d_model), seed=2)
    pos = np.arange(48)
    want = jattn.mla_attention(jcfg, jp, jx, jnp.asarray(pos))
    got = attn.mla_attention(tcfg, tp, tx, torch.from_numpy(pos))
    assert got.shape == (2, 48, tcfg.d_model) and got.dtype == tcfg.act_dtype
    np.testing.assert_allclose(_np(got), _np(want), **_tol(dtype))


@pytest.mark.parametrize("dtype", DTYPES)
def test_sdpa_vd_loops_match_reference(dtype):
    """The same q, k (qk 48) and v (32) through both sides' chunked and
    unrolled loops and the full-matrix path."""
    jcfg, tcfg = _cfgs("deepseek-v2-236b", dtype)
    B, S, H = 2, 24, 4
    jq, tq = _pair(jcfg, tcfg, (B, S, H, 48), seed=3)
    jk, tk = _pair(jcfg, tcfg, (B, S, H, 48), seed=4)
    jv, tv = _pair(jcfg, tcfg, (B, S, H, 32), seed=5)
    scale = 1.0 / math.sqrt(48)
    for got, want in (
            (attn._sdpa_chunked_vd(tq, tk, tv, 4, scale),
             jattn._sdpa_chunked_vd(jq, jk, jv, 4, scale)),
            (attn._sdpa_unrolled_vd(tq, tk, tv, 6, scale),
             jattn._sdpa_unrolled_vd(jq, jk, jv, 6, scale)),
            (attn._mla_sdpa(tcfg, tq, tk, tv),
             jattn._mla_sdpa(jcfg, jq, jk, jv))):
        assert tuple(got.shape) == want.shape == (B, S, H, 32)
        np.testing.assert_allclose(_np(got), _np(want), **_tol(dtype))


def test_init_mla_cache_matches_reference():
    jcfg, tcfg = _cfgs("deepseek-v2-236b", "bfloat16")
    j = jattn.init_mla_cache(jcfg, 2, 16)
    t = attn.init_mla_cache(tcfg, 2, 16, device="cpu")
    assert list(t) == list(j) == ["c_kv", "k_rope"]
    for key in t:
        assert tuple(t[key].shape) == j[key].shape
        assert t[key].dtype == torch.bfloat16 and not t[key].any()


@pytest.mark.parametrize("dtype", DTYPES)
def test_mla_append_kv_and_decode_match_reference(mla_tree, dtype):
    """One token at positions 3 and 27 of two random latent caches."""
    jcfg, tcfg, jp, tp = _mla_case(mla_tree, dtype)
    m = tcfg.mla
    B, S_max = 2, 40
    jx, tx = _pair(jcfg, tcfg, (B, 1, tcfg.d_model), seed=6)
    jc, tc = _pair(jcfg, tcfg, (B, S_max, m.kv_lora), seed=7)
    jr, tr = _pair(jcfg, tcfg, (B, S_max, m.qk_rope), seed=8)
    pos = np.array([3, 27], np.int32)
    jc, jr = jattn.mla_append_kv(jcfg, jp, jx, jc, jr, jnp.asarray(pos))
    tpos = torch.from_numpy(pos)
    c2, r2 = attn.mla_append_kv(tcfg, tp, tx, tc, tr, tpos)
    assert c2 is tc and r2 is tr                       # written in place
    np.testing.assert_allclose(_np(tc), _np(jc), **_tol(dtype))
    np.testing.assert_allclose(_np(tr), _np(jr), **_tol(dtype))
    want = jattn.mla_decode(jcfg, jp, jx, jc, jr, jnp.asarray(pos))
    got = attn.mla_decode(tcfg, tp, tx, tc, tr, tpos)
    assert got.shape == (B, 1, tcfg.d_model)
    np.testing.assert_allclose(_np(got), _np(want), **_tol(dtype))


def test_absorbed_decode_equals_decompressed_attention(mla_tree):
    """Within the port: the latent decode of the last of 13 tokens (its
    cache filled by ``_mla_qkv``) equals the decompressed
    ``mla_attention``'s last row, in f32."""
    _, tcfg, _, tp = _mla_case(mla_tree, impl="naive")
    S = 13
    x = torch.from_numpy(np.random.default_rng(9).standard_normal(
        (1, S, tcfg.d_model), np.float32))
    pos = torch.arange(S)
    full = attn.mla_attention(tcfg, tp, x, pos)
    cache = attn.init_mla_cache(tcfg, 1, 16, device="cpu")
    _, _, _, (c_kv, k_rope) = attn._mla_qkv(tcfg, tp, x[:, :S - 1],
                                            pos[:S - 1])
    cache["c_kv"][0, :, :S - 1] = c_kv
    cache["k_rope"][0, :, :S - 1] = k_rope
    last = torch.tensor([S - 1], dtype=torch.int32)
    attn.mla_append_kv(tcfg, tp, x[:, -1:], cache["c_kv"][0],
                       cache["k_rope"][0], last)
    got = attn.mla_decode(tcfg, tp, x[:, -1:], cache["c_kv"][0],
                          cache["k_rope"][0], last)
    torch.testing.assert_close(got[:, 0], full[:, -1], **F32)


# ---------------------------------------------------------------------------
# the whole model: both MoE families
# ---------------------------------------------------------------------------

class Routes:
    """The router's choices and f32 logits of every call, in call order,
    on both sides (the reference's through ``jax.debug.callback``, which
    runs inside its jitted forward and layer scan)."""

    def __init__(self, monkeypatch):
        self.ref, self.port = [], []
        jreal, treal = jmoe._router, moe._router

        def jspy(cfg, p, xf):
            out = jreal(cfg, p, xf)
            logits = xf.astype(jnp.float32) @ p["router"].astype(jnp.float32)
            jax.debug.callback(lambda i, lg: self.ref.append(
                (np.asarray(i), np.asarray(lg))), out[1], logits,
                ordered=True)
            return out

        def tspy(cfg, p, xf):
            out = treal(cfg, p, xf)
            self.port.append((out[1].numpy(),
                              (xf.float() @ p["router"].float()).numpy()))
            return out

        monkeypatch.setattr(jmoe, "_router", jspy)
        monkeypatch.setattr(moe, "_router", tspy)

    def take(self, B):
        """The calls since the last ``take``, one a layer in layer order:
        flipped ``[B, T]`` (some layer chose another expert set for that
        token) and the largest ``|Δ router logit| / max |router logit|``
        over the tokens whose earlier layers all chose alike (a flip
        changes its token's input to the next layer)."""
        jax.effects_barrier()
        assert len(self.ref) == len(self.port) > 0
        flipped, gap = None, 0.0
        for (ri, rl), (pi, pl) in zip(self.ref, self.port):
            if flipped is None:
                flipped = np.zeros(ri.shape[0], bool)
            same = ~flipped
            gap = max(gap, float(np.abs(rl - pl)[same].max(initial=0.0)
                                 / np.abs(rl).max()))
            flipped |= (np.sort(ri, -1) != np.sort(pi, -1)).any(-1)
        self.ref.clear()
        self.port.clear()
        return flipped.reshape(B, -1), gap


def _held(got, want, flipped, dtype, what):
    """f32: every position, and no flip, elementwise.  bf16: every
    position whose routing agreed, within 6e-2 × max |logit| (the bound
    ``tests/test_torch_recurrent_models.py`` holds whole-model bf16 logits
    to: elementwise, bf16 rounding alone fails at this logit scale).  ``got``/``want`` ``[B, T, V]``; ``flipped``
    ``[B, T]``.  Returns the flipped positions' count."""
    got, want = _np(got), _np(want)
    if dtype == "float32":
        assert not flipped.any(), (what, np.argwhere(flipped))
        np.testing.assert_allclose(got, want, err_msg=what, **F32)
        return 0
    keep = ~flipped
    err = float(np.abs(got[keep] - want[keep]).max(initial=0.0))
    assert err <= 6e-2 * float(np.abs(want).max()), (what, err)
    return int(flipped.sum())


@pytest.fixture(scope="module", params=MOE_ARCHS)
def family(request):
    """The reference's init (seed 0, f32 activations) of each MoE
    family's smoke model, as numpy arrays."""
    jcfg, _ = _cfgs(request.param)
    return request.param, jax.tree.map(
        np.asarray, jbuild_model(jcfg).init(jax.random.key(0)))


def _to_reference(params):
    """The port's parameters back as the reference's tree of numpy
    arrays, layers stacked on a leading ``L`` axis (bf16 by its bits)."""
    def leaf(t):
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(jnp.bfloat16)
        return t.numpy()
    layers = [jax.tree.map(leaf, p) for p in params["layers"]]
    return {"embed": jax.tree.map(leaf, params["embed"]),
            "layers": jax.tree.map(lambda *xs: np.stack(xs), *layers),
            "final_norm": leaf(params["final_norm"])}


def test_params_round_trip_bit_for_bit(family):
    """``params_from_reference`` carries the MoE and MLA trees (router,
    ``w_gate [E, D, F]``, ``shared``, ``wq_a`` … ``wv_b``) in their bf16
    bit for bit, and the port's own ``init`` makes the same tree; the
    parameter count is the reference's (which leaves MLA's two norm
    scales out of ``n_params``)."""
    name, tree = family
    _, tcfg = _cfgs(name)
    params = params_from_reference(tcfg, tree, device="cpu")
    back = _to_reference(params)
    flat, tdef = jax.tree.flatten(tree)
    flat2, tdef2 = jax.tree.flatten(back)
    assert tdef == tdef2
    for a, b in zip(flat, flat2):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))
    leaves = jax.tree.leaves(tree)
    assert any(a.dtype == jnp.bfloat16 for a in leaves)
    mlp = params["layers"][0]["mlp"]
    e = tcfg.moe
    assert tuple(mlp["w_gate"].shape) == (e.n_experts, tcfg.d_model,
                                          e.d_ff_expert)
    assert ("shared" in mlp) == (e.n_shared > 0)
    own = build_model(tcfg, device="cpu").init(
        torch.Generator().manual_seed(0))
    assert jax.tree.structure(_to_reference(own)) == tdef
    count = sum(a.size for a in leaves)
    norms = (tcfg.mla.q_lora + tcfg.mla.kv_lora) * tcfg.n_layers \
        if tcfg.mla else 0
    assert count - norms == tcfg.n_params() == \
        jconfigs.get_smoke(name).n_params()


@pytest.mark.parametrize("impl", ["xla_chunked", "pallas"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_forward_prefill_decode_loss_match_reference(family, dtype, impl,
                                                     monkeypatch):
    """Over 32 tokens (two sequences) with ``attn_chunk`` 8: ``forward``
    and its ``aux``, ``loss`` with some labels masked, a prefill of 24
    tokens and 8 teacher-forced decode steps (their logits and the
    caches) against the reference's."""
    name, tree = family
    jcfg, tcfg = _cfgs(name, dtype, impl, chunk=8)
    jm = jbuild_model(jcfg)
    jp = jax.tree.map(jnp.asarray, tree)
    tm = build_model(tcfg, device="cpu")
    tp = params_from_reference(tcfg, tree, device="cpu")
    routes = Routes(monkeypatch)
    B, S, n = 2, 24, 8
    rng = np.random.default_rng(11)
    toks = rng.integers(0, tcfg.vocab, (B, S + n))
    labels = np.where(rng.random((B, S + n)) < 0.2, -1,
                      rng.integers(0, tcfg.vocab, (B, S + n)))

    jl, ja = jax.jit(jm.forward)(jp, jnp.asarray(toks, jnp.int32))
    tl, ta = tm.forward(tp, torch.from_numpy(toks))
    flipped, gap = routes.take(B)
    assert ta.dtype == torch.float32 and float(ta) > 0
    n_flipped = _held(tl, jl, flipped, dtype, "forward")
    assert n_flipped <= 0.1 * flipped.size, np.argwhere(flipped)
    assert gap <= (1e-4 if dtype == "float32" else 6e-2), gap
    np.testing.assert_allclose(float(ta), float(ja), **_tol(dtype))
    jloss = jax.jit(jm.loss)(jp, jnp.asarray(toks, jnp.int32),
                             jnp.asarray(labels, jnp.int32))
    tloss = tm.loss(tp, torch.from_numpy(toks), torch.from_numpy(labels))
    routes.take(B)
    np.testing.assert_allclose(float(tloss), float(jloss), **_tol(dtype))

    jc, tc = jm.init_cache(B, 40), tm.init_cache(B, 40)
    assert list(tc) == list(jc)
    jlog, jc = jax.jit(jm.prefill)(jp, jnp.asarray(toks[:, :S], jnp.int32),
                                   jc)
    tlog, tc2 = tm.prefill(tp, torch.from_numpy(toks[:, :S]), tc)
    assert tc2 is tc
    flipped, gap = routes.take(B)
    n_flipped = _held(tlog, jlog, flipped[:, -1:], dtype, "prefill")
    jdec = jax.jit(jm.decode_step)
    for i in range(S, S + n):
        pos = np.full(B, i, np.int32)
        jlog, jc = jdec(jp, jnp.asarray(toks[:, i:i + 1], jnp.int32), jc,
                        jnp.asarray(pos))
        tlog, tc = tm.decode_step(tp, torch.from_numpy(toks[:, i:i + 1]),
                                  tc, torch.from_numpy(pos))
        flipped, step_gap = routes.take(B)
        gap = max(gap, step_gap)
        n_flipped += _held(tlog, jlog, flipped, dtype, f"decode step {i}")
    assert n_flipped <= 0.1 * B * (n + 1), n_flipped
    assert gap <= (1e-4 if dtype == "float32" else 6e-2), gap
    if dtype == "float32":
        for key in tc:
            np.testing.assert_allclose(_np(tc[key]), _np(jc[key]), **F32)
