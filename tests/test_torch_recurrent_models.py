"""Port recurrent families (rwkv6, zamba2 hybrid) against the JAX package
on the smoke configs of rwkv6-3b and zamba2-2.7b.

Parameters come from the reference's own ``init`` and are carried across
with ``repro_torch.convert.params_from_reference``; inputs are drawn with
numpy.  Tolerances, as ``tests/test_torch_models.py``'s:

* f32: 1e-4 (relative and absolute) — the same f32 math in another
  summation order across frameworks;
* bf16: ``tests/test_models.py``'s 6e-2 — bf16 rounds at other places in
  the two frameworks (XLA on the CPU keeps chains of bf16 elementwise ops
  in f32; torch rounds after each op).  Blocks are held to it element by
  element.  The whole model's logits and caches are held to ``6e-2 ×
  max |value|`` of each tensor, the bound ``chip_smoke.py`` holds the
  served models to: their scale is larger than the dense models' (logits
  up to 4.1, the WKV state up to 38, against 0.9 for olmo-1b's logits),
  and the elementwise form fails there by bf16 rounding alone, which
  ``test_bf16_as_accurate_as_the_reference`` shows: against the
  reference's f32, the port's bf16 is as close as the reference's own
  bf16.

On the CPU the scans run the kernels' plain chunked forms; the chip check
(``chip_smoke.py`` phases 9-11) holds the kernels against them.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import mamba2 as jm2
from repro.models import rwkv6 as jrk
from repro.models import transformer as jtr
from repro_torch import configs
from repro_torch.convert import params_from_reference
from repro_torch.models import mamba2 as m2
from repro_torch.models import rwkv6 as rk
from repro_torch.models import transformer as tr

F32 = {"rtol": 1e-4, "atol": 1e-4}
BF16 = {"rtol": 6e-2, "atol": 6e-2}
RECURRENT = ("rwkv6-3b", "zamba2-2.7b")
DTYPES = ("float32", "bfloat16")


def _cfgs(name, dtype="float32", impl="pallas"):
    return tuple(dataclasses.replace(c.get_smoke(name), attn_impl=impl,
                                     dtype=dtype)
                 for c in (jconfigs, configs))


def _tol(dtype):
    return F32 if dtype == "float32" else BF16


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), **tol)


def _close_model(got, want, dtype):
    """f32 element by element; bf16 within 6e-2 × max |want|."""
    if dtype == "float32":
        return _close(got, want, F32)
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= BF16["atol"] * scale, (err, scale)


@functools.cache
def _reference_tree(name, seed):
    """The reference's ``init`` at ``seed`` as numpy arrays (the smoke
    config's; parameters do not depend on the activation dtype)."""
    jp = jtr.build_model(jconfigs.get_smoke(name)).init(jax.random.key(seed))
    return jax.tree.map(np.asarray, jp)


@pytest.fixture(scope="module", params=RECURRENT)
def ref_tree(request):
    jcfg, tcfg = _cfgs(request.param)
    tree = _reference_tree(request.param, 0)
    return request.param, jcfg, tcfg, jax.tree.map(jnp.asarray, tree), tree


def _layer0_pair(name, dtype, seed=5):
    """Layer 0's parameters on both sides, and the configs."""
    jcfg, tcfg = _cfgs(name, dtype)
    tree = _reference_tree(name, seed)
    jp = jax.tree.map(lambda a: jnp.asarray(a[0]), tree["layers"])
    tp = params_from_reference(tcfg, tree, device="cpu")
    return jcfg, tcfg, jp, tp["layers"][0], tree, tp


def _x(shape, dtype, seed=6):
    x = np.random.default_rng(seed).standard_normal(shape, np.float32)
    return (torch.from_numpy(x).to(getattr(torch, dtype)),
            jnp.asarray(x, getattr(jnp, dtype)))


def params_to_reference(params):
    """The port's parameters back as the reference's tree of numpy arrays
    (layers stacked on a leading ``L`` axis, other subtrees whole)."""
    layers = [jax.tree.map(lambda x: x.numpy(), p) for p in params["layers"]]
    out = {k: jax.tree.map(lambda x: x.numpy(), v)
           for k, v in params.items() if k != "layers"}
    out["layers"] = jax.tree.map(lambda *xs: np.stack(xs), *layers)
    return out


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------

def test_params_round_trip_bit_for_bit(ref_tree):
    """Every top-level subtree comes across, the hybrid's ``shared``
    attention block among them, bit for bit."""
    name, jcfg, tcfg, jp, tree = ref_tree
    params = params_from_reference(tcfg, tree, device="cpu")
    assert set(params) == set(tree)
    assert len(params["layers"]) == tcfg.n_layers
    back = params_to_reference(params)
    flat, tdef = jax.tree.flatten(tree)
    flat2, tdef2 = jax.tree.flatten(back)
    assert tdef == tdef2
    for a, b in zip(flat, flat2):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))
    if "shared" in tree:
        np.testing.assert_array_equal(params["shared"]["attn"]["wq"].numpy(),
                                      tree["shared"]["attn"]["wq"])


def test_port_init_matches_reference_shapes_and_law(ref_tree):
    name, jcfg, tcfg, jp, tree = ref_tree
    model = tr.build_model(tcfg, device="cpu")
    back = params_to_reference(model.init(torch.Generator().manual_seed(0)))
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert a.shape == b.shape and a.dtype == b.dtype
    w = back["layers"]["tm"]["wr"] if name == "rwkv6-3b" else \
        back["layers"]["m"]["in_proj"]
    assert abs(float(w.std()) * np.sqrt(tcfg.d_model) - 1) < 0.05
    assert abs(float(back["embed"]["tok"].std()) / 0.02 - 1) < 0.05


# ---------------------------------------------------------------------------
# rwkv6 blocks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("T", [1, 21])
@pytest.mark.parametrize("dtype", DTYPES)
def test_rwkv_time_mix_matches_reference(T, dtype):
    """``_ddlerp`` and ``time_mix`` (the chunked scan at T > 1, one WKV
    step at T == 1) from a nonzero carried state."""
    jcfg, tcfg, jp, tp, _, _ = _layer0_pair("rwkv6-3b", dtype)
    B, D = 2, tcfg.d_model
    H, K = D // tcfg.rwkv.head_size, tcfg.rwkv.head_size
    tx, jx = _x((B, T, D), dtype)
    ts, js = _x((B, D), dtype, seed=7)
    rng = np.random.default_rng(8)
    s0 = rng.standard_normal((B, H, K, K), np.float32) * 0.1
    tol = _tol(dtype)
    jprev = jnp.concatenate([js[:, None], jx[:, :-1]], axis=1)
    tprev = torch.cat([ts[:, None], tx[:, :-1]], dim=1)
    _close(rk._ddlerp(tp["tm"], tx, tprev), jrk._ddlerp(jp["tm"], jx, jprev),
           tol)
    got = rk.time_mix(tcfg, tp["tm"], tx, ts, torch.from_numpy(s0),
                      chunk=8)
    want = jrk.time_mix(jcfg, jp["tm"], jx, js, jnp.asarray(s0), chunk=8)
    assert got[0].dtype == tcfg.act_dtype and got[2].dtype == torch.float32
    for g, w in zip(got, want):
        _close(g, w, tol)


@pytest.mark.parametrize("dtype", DTYPES)
def test_rwkv_channel_mix_and_block_match_reference(dtype):
    jcfg, tcfg, jp, tp, _, _ = _layer0_pair("rwkv6-3b", dtype)
    B, T, D = 2, 9, tcfg.d_model
    tx, jx = _x((B, T, D), dtype)
    ts, js = _x((B, D), dtype, seed=7)
    tol = _tol(dtype)
    for g, w in zip(rk.channel_mix(tcfg, tp["cm"], tx, ts),
                    jrk.channel_mix(jcfg, jp["cm"], jx, js)):
        _close(g, w, tol)
    tst = rk.init_rwkv_state(tcfg, B, n_layers=1)
    jst = jrk.init_rwkv_state(jcfg, B, n_layers=1)
    for key in tst:
        assert tuple(tst[key].shape) == jst[key].shape
    tst = {k: v[0] for k, v in tst.items()}
    jst = jax.tree.map(lambda a: a[0], jst)
    got = rk.rwkv_block(tcfg, tp, tx, tst, chunk=4)
    want = jrk.rwkv_block(jcfg, jp, jx, jst, chunk=4)
    _close(got[0], want[0], tol)
    for key in got[1]:
        _close(got[1][key], want[1][key], tol)


# ---------------------------------------------------------------------------
# mamba2 blocks and the shared attention block
# ---------------------------------------------------------------------------

def test_causal_conv_matches_reference():
    rng = np.random.default_rng(9)
    seq = rng.standard_normal((2, 11, 24), np.float32)
    w = rng.standard_normal((4, 24), np.float32)
    b = rng.standard_normal(24, np.float32)
    carry = rng.standard_normal((2, 3, 24), np.float32)
    got = m2._causal_conv(*(torch.from_numpy(a) for a in (seq, w, b, carry)))
    want = jm2._causal_conv(*(jnp.asarray(a) for a in (seq, w, b, carry)))
    for g, ww in zip(got, want):
        _close(g, ww, F32)


@pytest.mark.parametrize("T", [1, 21])
@pytest.mark.parametrize("dtype", DTYPES)
def test_mamba2_block_matches_reference(T, dtype):
    """The block (the chunked scan at T > 1, one SSD step at T == 1) from
    a nonzero carried state."""
    jcfg, tcfg, jp, tp, _, _ = _layer0_pair("zamba2-2.7b", dtype)
    B = 2
    tx, jx = _x((B, T, tcfg.d_model), dtype)
    st = jax.tree.map(lambda a: a[0], jm2.init_mamba_state(jcfg, B, 1))
    rng = np.random.default_rng(10)
    conv = rng.standard_normal(st["conv"].shape, np.float32)
    ssm = rng.standard_normal(st["ssm"].shape, np.float32) * 0.1
    jst = {"conv": jnp.asarray(conv, jcfg.act_dtype),
           "ssm": jnp.asarray(ssm)}
    tst = {"conv": torch.from_numpy(conv).to(tcfg.act_dtype),
           "ssm": torch.from_numpy(ssm)}
    got = m2.mamba2_block(tcfg, tp["m"], tx, tst)
    want = jm2.mamba2_block(jcfg, jp["m"], jx, jst)
    tol = _tol(dtype)
    _close(got[0], want[0], tol)
    for key in ("conv", "ssm"):
        assert got[1][key].dtype == tst[key].dtype
        _close(got[1][key], want[1][key], tol)


@pytest.mark.parametrize("dtype", DTYPES)
def test_shared_attn_block_and_decode_match_reference(dtype):
    jcfg, tcfg, _, _, tree, tparams = _layer0_pair("zamba2-2.7b", dtype)
    jsp = jax.tree.map(jnp.asarray, tree["shared"])
    tsp = tparams["shared"]
    tol = _tol(dtype)
    S = 13
    tx, jx = _x((2, S, tcfg.d_model), dtype)
    got = tr.shared_attn_block(tcfg, tsp, tx, torch.arange(S))
    want = jtr.shared_attn_block(jcfg, jsp, jx, jnp.arange(S), want_kv=True)
    _close(got[0], want[0], tol)
    for g, w in zip(got[1], want[1]):
        _close(g, w, tol)
    rng = np.random.default_rng(11)
    kc = rng.standard_normal((2, 24, tcfg.n_kv_heads, tcfg.head_dim),
                             np.float32)
    vc = rng.standard_normal(kc.shape, np.float32)
    pos = np.array([4, 17], np.int32)
    t1, j1 = _x((2, 1, tcfg.d_model), dtype, seed=12)
    tkc = torch.from_numpy(kc).to(tcfg.act_dtype)
    tvc = torch.from_numpy(vc).to(tcfg.act_dtype)
    out = tr.shared_attn_decode(tcfg, tsp, t1, tkc, tvc,
                                torch.from_numpy(pos))
    jout, jk, jv = jtr.shared_attn_decode(
        jcfg, jsp, j1, jnp.asarray(kc, jcfg.act_dtype),
        jnp.asarray(vc, jcfg.act_dtype), jnp.asarray(pos))
    _close(out, jout, tol)
    _close(tkc, jk, tol)                              # written in place
    _close(tvc, jv, tol)


# ---------------------------------------------------------------------------
# the whole model: forward, prefill, decode_step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", RECURRENT)
@pytest.mark.parametrize("dtype", DTYPES)
def test_forward_prefill_decode_match_reference(name, dtype):
    """Prefill a 37-token prompt (ragged against the smoke chunk), then 6
    teacher-forced decode steps: the prefill logits, every step's logits,
    the greedy tokens and the final cache against JAX's ``build_model``
    with ``attn_impl="pallas"``, and the full forward over all 43
    tokens."""
    jcfg, tcfg = _cfgs(name, dtype)
    jm, tm = jtr.build_model(jcfg), tr.build_model(tcfg, device="cpu")
    tree = _reference_tree(name, 0)
    jp = jax.tree.map(jnp.asarray, tree)
    tp = params_from_reference(tcfg, tree, device="cpu")
    S, n, max_len = 37, 6, 48
    toks = np.random.default_rng(13).integers(0, tcfg.vocab, (1, S + n))
    jl, _ = jax.jit(jm.forward)(jp, jnp.asarray(toks, jnp.int32))
    tl, aux = tm.forward(tp, torch.from_numpy(toks))
    assert float(aux) == 0.0 and tl.dtype == tcfg.act_dtype
    _close_model(tl, jl, dtype)

    jc, tc = jm.init_cache(1, max_len), tm.init_cache(1, max_len)
    assert set(tc) == set(jc)
    for key in tc:
        assert tuple(tc[key].shape) == jc[key].shape
    jlog, jc = jax.jit(jm.prefill)(jp, jnp.asarray(toks[:, :S], jnp.int32),
                                   jc)
    tlog, tc2 = tm.prefill(tp, torch.from_numpy(toks[:, :S]), tc)
    assert tc2 is tc
    _close_model(tlog, jlog, dtype)
    jdec = jax.jit(jm.decode_step)
    for i in range(n):
        tok = toks[:, S + i:S + i + 1]
        pos = np.array([S + i], np.int32)
        jlog, jc = jdec(jp, jnp.asarray(tok, jnp.int32), jc,
                        jnp.asarray(pos))
        tlog, tc = tm.decode_step(tp, torch.from_numpy(tok), tc,
                                  torch.from_numpy(pos))
        assert tlog.shape == (1, 1, tcfg.vocab)
        _close_model(tlog, jlog, dtype)
        _close_model(tlog[:, 0], tl[:, S + i], dtype)
        if dtype == "float32":
            assert int(tlog.argmax()) == int(jnp.argmax(jlog))
    for key in tc:
        _close_model(tc[key], jc[key], dtype)


def _served_outputs(model, params, toks, S, steps, as_array):
    """The forward's logits and the cache after prefilling ``S`` tokens
    and ``steps`` teacher-forced decode steps, as f32 numpy arrays."""
    out = {"logits": _np(model.forward(params, as_array(toks))[0])}
    cache = model.init_cache(1, S + steps)
    _, cache = model.prefill(params, as_array(toks[:, :S]), cache)
    for i in range(S, S + steps):
        _, cache = model.decode_step(params, as_array(toks[:, i:i + 1]),
                                     cache, as_array(np.array([i], np.int32)))
    out.update({k: _np(v) for k, v in cache.items()})
    return out


@pytest.mark.parametrize("name", RECURRENT)
def test_bf16_as_accurate_as_the_reference(name, capsys):
    """The ground of the bf16 bound above: against the reference's f32
    run, the port's bf16 logits and caches are as close as the
    reference's own bf16 (RMS error within 1.5×).  The RMS over each
    tensor is held, not its largest element, which turns on one logit: the
    reference's ``init`` draws other weights once any module has enabled
    JAX's x64 (importing ``repro.core.simulator`` does, and every pytest
    worker collects such files), and with those weights rwkv6's largest
    logit gap is 0.233 against the reference's 0.145 (1.6×) while the RMS
    ratio is 1.03; without x64 the largest gaps are 0.087 and 0.097.  The
    RMS ratios lie in 0.82-1.03 for every tensor of both models, with x64
    on or off and at every CPU thread count from 1 to 8.  ``-s`` prints
    both statistics."""
    S, steps = 37, 6
    runs = {}
    for dtype in DTYPES:
        jcfg, tcfg = _cfgs(name, dtype)
        jm = jtr.build_model(jcfg)
        tree = _reference_tree(name, 0)
        jp = jax.tree.map(jnp.asarray, tree)
        toks = np.random.default_rng(13).integers(0, jcfg.vocab,
                                                  (1, S + steps))
        jitted = jm._replace(**{f: jax.jit(getattr(jm, f)) for f in
                                ("forward", "prefill", "decode_step")})
        runs[f"reference {dtype}"] = _served_outputs(
            jitted, jp, toks, S, steps, lambda a: jnp.asarray(a))
        if dtype == "bfloat16":
            tm = tr.build_model(tcfg, device="cpu")
            tp = params_from_reference(tcfg, tree, device="cpu")
            runs["port bfloat16"] = _served_outputs(
                tm, tp, toks, S, steps, torch.from_numpy)
    truth = runs["reference float32"]
    for key, want in truth.items():
        gap = {side: runs[f"{side} bfloat16"][key] - want
               for side in ("port", "reference")}
        rms = {side: float(np.sqrt(np.mean(np.square(d))))
               for side, d in gap.items()}
        with capsys.disabled():
            print(f"{name} {key}: |bf16 - reference f32| RMS port "
                  f"{rms['port']:.5f}, reference {rms['reference']:.5f}; max "
                  f"port {np.abs(gap['port']).max():.4f}, reference "
                  f"{np.abs(gap['reference']).max():.4f}; scale "
                  f"{np.abs(want).max():.3f}")
        assert rms["port"] <= 1.5 * rms["reference"], (key, rms)


@pytest.mark.parametrize("name", RECURRENT)
def test_default_attn_impl(name):
    """Both recurrent families build and run under their config's default
    ``attn_impl`` (``xla_chunked``): rwkv6 has no attention, and the
    hybrid's shared block runs the chunked loop past ``attn_chunk`` (here
    4), equal to its naive attention."""
    cfg = dataclasses.replace(configs.get_smoke(name), dtype="float32")
    assert cfg.attn_impl == "xla_chunked"
    model = tr.build_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (1, 8)))
    logits, _ = model.forward(params, toks)
    assert logits.shape == (1, 8, cfg.vocab)
    assert bool(logits.isfinite().all())
    if name == "zamba2-2.7b":
        chunked = tr.build_model(dataclasses.replace(cfg, attn_chunk=4),
                                 device="cpu")
        naive = tr.build_model(dataclasses.replace(cfg, attn_impl="naive"),
                               device="cpu")
        torch.testing.assert_close(chunked.forward(params, toks)[0],
                                   naive.forward(params, toks)[0], **F32)
