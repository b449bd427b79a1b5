"""The port's sharded training on real multi-rank ``gloo`` groups on the
CPU, against the reference's single-device runs from the same weights
(the counterpart of ``tests/test_distributed.py:25-67`` and
``:125-169``, its tolerances; the compressed step is in
``test_torch_distributed_pods.py``).

Each test starts one process a rank (``tests/torch_dist_worker.py``; the
rendezvous and every collective time out after 90 s, the whole group
after 150 s, so a hang fails one test).  The reference side runs here,
on one device; its weights cross to the ranks as numpy arrays
(``repro_torch.convert.params_from_reference``).

* the sharded train step on a (2, 2) ``data × model`` mesh: 3 AdamW
  steps, loss within 2e-3 and every parameter within 1e-3 of the
  port's one-device run and of the reference's; for granite-20b's MQA
  too, whose KV head stays whole while its query heads split;
* the elastic re-mesh: gemma-2b's smoke parameters laid out on (2, 4),
  saved, restored onto (4, 2): bit for bit, on the new mesh's
  placements;
* the rules ``make_ctx`` switches on per config and shape, on (2, 2)
  under ``make_ctx`` (``tests/test_distributed.py:25-95, 172-202``'s
  bounds): the train step with ``fsdp`` on (the parameters' ``fsdp`` dim
  over ``data``); ``moe_ep`` with ``fsdp`` on, its experts' weights
  gathered over ``data`` before use, against the reference's
  ``moe_dense``; decode steps under a decode shape (FSDP off, the
  experts' ff dim over ``data``) against the reference's.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from repro import configs as jconfigs
from repro.data.pipeline import random_batch
from repro.models import moe as jmoe
from repro.models import transformer as jtr
from repro.models.common import MoECfg as JMoECfg
from repro_torch.convert import params_from_reference
from repro_torch.training.optimizer import OptCfg
from repro_torch.training.tree import flatten_with_paths
from torch_dist_ref import f32
from torch_dist_ref import leaves as _leaves
from torch_dist_ref import ref_params as _ref_params
from torch_dist_ref import ref_steps as _ref_steps
from torch_dist_worker import Ranks


def test_sharded_train_matches_single_device(tmp_path):
    _train_matches(tmp_path, fsdp=False)


def test_sharded_train_under_fsdp_matches_single_device(tmp_path):
    _train_matches(tmp_path, fsdp=True)


def test_sharded_mqa_train_matches_single_device(tmp_path):
    """granite-20b's smoke config (4 query heads on 1 KV head): the query
    heads split over model and the KV head stays whole, so each rank's
    share of the KV projections' gradient is summed over model (a sharded
    step without that sum moved the loss by 3.3e-2 at step 2)."""
    _train_matches(tmp_path, fsdp=False, arch="granite-20b")


def _train_matches(tmp_path, fsdp, arch="olmo-1b"):
    ocfg = OptCfg(lr=1e-2, warmup_steps=2, total_steps=10)
    tokens, labels = random_batch(0, 4, 32, 512)
    jp, tp, inp = _ref_params(arch)
    ranks = Ranks("train", 4, dict(inp, tokens=tokens, labels=labels,
                                   arch=np.array(arch), fsdp=np.bool_(fsdp)),
                  tmp_path)
    ref_losses, ref_params = _ref_steps(arch, ocfg, jp, tokens, labels, 3)
    outs = ranks.wait()
    r0 = outs[0]
    print("losses", [float(r0[f"loss{i}"]) for i in range(3)],
          "single", [float(r0[f"single_loss{i}"]) for i in range(3)],
          "reference", ref_losses)
    # the parameters are laid out over both axes, not replicated; with
    # fsdp a weight's fsdp dim over data and its ff dim over model
    assert any("Shard" in p for p in r0["placements"])
    assert str(r0["fsdp"]) == ("data" if fsdp else "None")
    assert ("(Shard(dim=0), Shard(dim=1))" in r0["placements"]) == fsdp
    for r in outs:
        for i in range(3):
            assert float(r[f"loss{i}"]) == float(r0[f"loss{i}"])
    for i in range(3):
        assert abs(float(r0[f"loss{i}"]) - float(r0[f"single_loss{i}"])) \
            < 2e-3
        assert abs(float(r0[f"loss{i}"]) - ref_losses[i]) < 2e-3
    for got, single, ref in zip(_leaves(r0, "sharded/", tp),
                                _leaves(r0, "single/", tp),
                                [t.numpy() for _, t in
                                 flatten_with_paths(ref_params)]):
        np.testing.assert_allclose(got, single, rtol=1e-3, atol=1e-3)
        np.testing.assert_allclose(got, ref, rtol=1e-3, atol=1e-3)


def test_elastic_remesh_checkpoint(tmp_path):
    _, tp, inp = _ref_params("gemma-2b")
    outs = Ranks("remesh", 8, dict(inp, dir=np.array(str(
        tmp_path / "ckpt"))), tmp_path).wait()
    for r in outs:
        assert int(r["step"]) == 1
        assert r["same"].all() and r["on_new_mesh"].all()
        for got, want in zip(_leaves(r, "restored/", tp),
                             [t.numpy() for _, t in flatten_with_paths(tp)]):
            np.testing.assert_array_equal(got, want.astype(np.float32))


def test_moe_ep_under_fsdp_matches_dense(tmp_path):
    kw = dict(n_experts=4, top_k=2, d_ff_expert=64, capacity_factor=16.0)
    jcfg = dataclasses.replace(jconfigs.get_smoke("dbrx-132b"),
                               moe=JMoECfg(**kw))
    with jax.enable_x64(False):
        p = jmoe.init_moe(jax.random.key(0), jcfg)
        x = jax.random.normal(jax.random.key(1), (4, 16, jcfg.d_model),
                              jnp.float32)
        y_ref, aux_ref = jmoe.moe_dense(jcfg, p, x)
    tp = params_from_reference(jcfg, p, "cpu")
    inp = {"p/" + "/".join(path): leaf.float().numpy()
           for path, leaf in flatten_with_paths(tp)}
    outs = Ranks("moe", 4, dict(inp, x=np.asarray(x), fsdp=np.bool_(True)),
                 tmp_path).wait()
    for r in outs:
        # experts over model, their d_model dim over data: gathered
        # before use, once a weight
        assert str(r["w_in_placements"]) == "(Shard(dim=1), Shard(dim=0))"
        assert list(r["gathers"]) == ["data"] * 3
        np.testing.assert_allclose(r["y"], np.asarray(y_ref, np.float32),
                                   rtol=2e-2, atol=2e-2)
        assert abs(float(r["aux"]) - float(aux_ref)) < 1e-3


def test_decode_under_decode_shape_rules(tmp_path):
    jcfg = f32("dbrx-132b", True)
    jp, _, inp = _ref_params("dbrx-132b")
    toks = np.random.default_rng(6).integers(0, jcfg.vocab, (2, 16))
    B, S = toks.shape
    ranks = Ranks("decode_rules", 4, dict(inp, toks=toks), tmp_path)
    with jax.enable_x64(False):
        model = jtr.build_model(jcfg)
        cache = model.init_cache(B, S + 2)
        _, cache = jax.jit(model.prefill)(jp, jnp.asarray(toks), cache)
        logits = []
        for i in range(2):
            lg, cache = jax.jit(model.decode_step)(
                jp, jnp.asarray(toks[:, i:i + 1]), cache,
                jnp.full((B,), S + i, jnp.int32))
            logits.append(np.asarray(lg, np.float32))
    want = np.concatenate(logits, axis=1)
    for r in ranks.wait():
        assert list(r["rules"]) == ["fsdp=None", "expert_ff=data",
                                    "act_seq=None", "seq_kv=None"]
        # the experts over model, their ff dim over data
        assert str(r["w_in_placements"]) == "(Shard(dim=2), Shard(dim=0))"
        np.testing.assert_allclose(r["logits"], want, rtol=1e-4, atol=1e-4)
        for name in ("k", "v"):
            np.testing.assert_allclose(r[f"cache/{name}"],
                                       np.asarray(cache[name], np.float32),
                                       rtol=1e-4, atol=1e-4)
