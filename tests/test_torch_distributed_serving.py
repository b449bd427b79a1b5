"""The port's sharded forward pieces on real multi-rank ``gloo`` groups on
the CPU, against the reference's single-device functions from the same
weights (the counterpart of ``tests/test_distributed.py:70-95`` and
``:172-202``, their tolerances).

* ``moe_ep`` on a (2, 2) mesh (experts over ``model``, tokens over both
  axes, ``all_to_all`` dispatch) against ``moe_dense``, dbrx-132b's smoke
  config with the capacity factor raised until no token drops: within
  2e-2, ``aux`` within 1e-3;
* the seq-sharded flash-decode: qwen3-14b's smoke config (kv heads 2 ∤
  model 4) on (2, 4), one decode step over a cache whose sequence dim is
  sharded: logits and the written cache within 1e-3;
* ``_gqa_tp_pad`` on a 4-rank ``model`` axis with H 6 and KV 2: the
  padded head count as the reference's, ``sdpa`` on the padded heads
  equal to the unsharded one, and a whole forward of that config within
  1e-5 of the port's unsharded run and 1e-4 of the reference's;
* prefill and two decode steps of olmo-1b's smoke config under
  ``attn_impl="pallas"`` (the attention kernels' plain versions on each
  rank's local heads here) on (2, 2), parameters and cache laid out by
  their specs: within 1e-4 of the reference;
* the same for deepseek-v2-236b's smoke config (MLA, MoE with a shared
  expert; f32): the prefill through ``moe_ep`` (its capacity holds every
  token here), the decode steps through the MLA flash-decode over a
  latent cache seq-sharded over ``model`` and the sharded ``moe_dense``:
  within 1e-4 of the reference.
"""
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from repro import configs as jconfigs
from repro.distribution import sharding as jsh
from repro.models import attention as jattn
from repro.models import moe as jmoe
from repro.models import transformer as jtr
from repro.models.common import MoECfg as JMoECfg
from repro_torch import configs
from repro_torch.convert import params_from_reference
from repro_torch.models.common import MoECfg
from repro_torch.training.tree import flatten_with_paths
from torch_dist_ref import f32
from torch_dist_ref import ref_params as _ref_params
from torch_dist_worker import Ranks


def _moe_cfgs():
    kw = dict(n_experts=4, top_k=2, d_ff_expert=64, capacity_factor=16.0)
    return (dataclasses.replace(jconfigs.get_smoke("dbrx-132b"),
                                moe=JMoECfg(**kw)),
            dataclasses.replace(configs.get_smoke("dbrx-132b"),
                                moe=MoECfg(**kw)))


def test_moe_ep_matches_dense_on_mesh(tmp_path):
    jcfg, cfg = _moe_cfgs()
    with jax.enable_x64(False):
        p = jmoe.init_moe(jax.random.key(0), jcfg)
        x = jax.random.normal(jax.random.key(1), (4, 16, jcfg.d_model),
                              jnp.float32)
        y_ref, aux_ref = jmoe.moe_dense(jcfg, p, x)
    tp = params_from_reference(cfg, p, "cpu")
    inp = {"p/" + "/".join(path): leaf.float().numpy()
           for path, leaf in flatten_with_paths(tp)}
    outs = Ranks("moe", 4, dict(inp, x=np.asarray(x)), tmp_path).wait()
    for r in outs:
        print("aux", float(r["aux"]), float(aux_ref))
        np.testing.assert_allclose(r["y"], np.asarray(y_ref, np.float32),
                                   rtol=2e-2, atol=2e-2)
        np.testing.assert_allclose(r["y"], r["y_dense"], rtol=2e-2,
                                   atol=2e-2)
        assert abs(float(r["aux"]) - float(aux_ref)) < 1e-3
        assert abs(float(r["aux_dense"]) - float(aux_ref)) < 1e-5


def test_seq_sharded_decode_cache_matches(tmp_path):
    B, S = 2, 32
    jcfg = f32("qwen3-14b", True)
    _, _, inp = _ref_params("qwen3-14b")
    with jax.enable_x64(False):
        model = jtr.build_model(jcfg)
        params = model.init(jax.random.key(0))
        toks = jax.random.randint(jax.random.key(1), (B, S), 0, jcfg.vocab)
        ranks = Ranks("seqdecode", 8, dict(inp, toks=np.asarray(toks)),
                      tmp_path)
        cache = model.init_cache(B, S + 4)
        _, cache_ref = jax.jit(model.prefill)(params, toks, cache)
        pos = jnp.full((B,), S, jnp.int32)
        dec_ref, cache2 = jax.jit(model.decode_step)(params, toks[:, :1],
                                                     cache_ref, pos)
    outs = ranks.wait()
    for r in outs:
        # kv heads 2 do not divide model 4: the cache's sequence dim is
        # the one sharded
        assert str(r["cache_spec"]) == \
            "Spec(None, ('data',), ('model',), None, None)"
        np.testing.assert_allclose(r["logits"], np.asarray(dec_ref),
                                   rtol=1e-3, atol=1e-3)
        for name in ("k", "v"):
            np.testing.assert_allclose(r[f"cache/{name}"],
                                       np.asarray(cache2[name]),
                                       rtol=1e-3, atol=1e-3)


class _RefMesh:
    def __init__(self, shape):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)


@contextlib.contextmanager
def _ref_ctx(ctx):
    tok = jsh._ctx.set(ctx)
    try:
        yield
    finally:
        jsh._ctx.reset(tok)


def test_gqa_tp_pad_on_four_ranks(tmp_path):
    kw = dict(n_heads=6, n_kv_heads=2, attn_impl="naive")
    jcfg = dataclasses.replace(f32("olmo-1b", True), **kw)
    jp, _, inp = _ref_params("olmo-1b", **kw)
    rng = np.random.default_rng(3)
    q = rng.standard_normal((2, 8, 6, 32)).astype(np.float32)
    k = rng.standard_normal((2, 8, 2, 32)).astype(np.float32)
    v = rng.standard_normal((2, 8, 2, 32)).astype(np.float32)
    tokens = rng.integers(0, jcfg.vocab, (2, 8))
    ranks = Ranks("gqapad", 4, dict(inp, q=q, k=k, v=v, tokens=tokens),
                  tmp_path)
    ctx = jsh.ShardCtx(mesh=_RefMesh({"data": 1, "model": 4}),
                       rules=jsh.make_rules())
    with jax.enable_x64(False):
        with _ref_ctx(ctx):
            qp, kp, vp, unpad = jattn._gqa_tp_pad(jcfg, jnp.asarray(q),
                                                  jnp.asarray(k),
                                                  jnp.asarray(v))
        assert unpad is not None
        o_ref = jattn.sdpa(jcfg, jnp.asarray(q), jnp.asarray(k),
                           jnp.asarray(v))
        logits_ref, _ = jtr.build_model(jcfg).forward(jp, jnp.asarray(tokens))
    outs = ranks.wait()
    for r in outs:
        assert [tuple(s) for s in r["padded_shape"]] == \
            [qp.shape, kp.shape, vp.shape]
        assert "Shard(dim=2)" in str(r["qp_placements"])
        np.testing.assert_array_equal(r["o"], r["o_ref"])
        np.testing.assert_allclose(r["o"], np.asarray(o_ref), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(r["logits"], r["logits_ref"], rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(r["logits"], np.asarray(logits_ref),
                                   rtol=1e-4, atol=1e-4)


def test_sharded_prefill_decode_under_pallas(tmp_path):
    jcfg = dataclasses.replace(f32("olmo-1b", True), attn_impl="naive")
    jp, _, inp = _ref_params("olmo-1b")
    toks = np.random.default_rng(4).integers(0, jcfg.vocab, (2, 8))
    B, S = toks.shape
    ranks = Ranks("serve", 4, dict(inp, toks=toks), tmp_path)
    with jax.enable_x64(False):
        model = jtr.build_model(jcfg)
        cache = model.init_cache(B, S + 2)
        lg, cache = jax.jit(model.prefill)(jp, jnp.asarray(toks), cache)
        logits = [np.asarray(lg)]
        for i in range(2):
            pos = jnp.full((B,), S + i, jnp.int32)
            lg, cache = jax.jit(model.decode_step)(
                jp, jnp.asarray(toks[:, i:i + 1]), cache, pos)
            logits.append(np.asarray(lg))
    want = np.concatenate(logits, axis=1)
    for r in ranks.wait():
        np.testing.assert_allclose(r["logits"], want, rtol=1e-4, atol=1e-4)
        for name in ("k", "v"):
            np.testing.assert_allclose(r[f"cache/{name}"],
                                       np.asarray(cache[name]), rtol=1e-4,
                                       atol=1e-4)


def test_sharded_mla_moe_prefill_decode(tmp_path):
    jcfg = f32("deepseek-v2-236b", True)
    jp, _, inp = _ref_params("deepseek-v2-236b")
    toks = np.random.default_rng(5).integers(0, jcfg.vocab, (2, 16))
    B, S = toks.shape
    ranks = Ranks("mla", 4, dict(inp, toks=toks), tmp_path)
    with jax.enable_x64(False):
        model = jtr.build_model(jcfg)
        cache = model.init_cache(B, S + 2)
        lg, cache = jax.jit(model.prefill)(jp, jnp.asarray(toks), cache)
        logits = [np.asarray(lg, np.float32)]
        for i in range(2):
            pos = jnp.full((B,), S + i, jnp.int32)
            lg, cache = jax.jit(model.decode_step)(
                jp, jnp.asarray(toks[:, i:i + 1]), cache, pos)
            logits.append(np.asarray(lg, np.float32))
    want = np.concatenate(logits, axis=1)
    for r in ranks.wait():
        # MLA's latent cache has no head dim: its sequence dim is sharded
        assert str(r["cache_spec"]) == "Spec(None, ('data',), ('model',), None)"
        np.testing.assert_allclose(r["logits"], want, rtol=1e-4, atol=1e-4)
        for name in ("c_kv", "k_rope"):
            np.testing.assert_allclose(r[f"cache/{name}"],
                                       np.asarray(cache[name], np.float32),
                                       rtol=1e-4, atol=1e-4)
