"""The MoE families' sharded training against the reference's sharded
run on the same mesh: the machinery of
``tests/test_torch_distributed_moe_train.py`` (dbrx-132b) and
``tests/test_torch_distributed_mla_train.py`` (deepseek-v2-236b).

The reference is held on the mesh, not on one device: ``moe_ep`` routes
each rank's token shard with ``_capacity`` slots an expert and averages
the ranks' aux losses (its ``pmean``), which the one-device dense path
does not.  The reference's side is ``jax.value_and_grad`` and its train
step under ``shard_map`` on 4 host devices in a subprocess; the port's is
``tests/torch_dist_worker.py``'s ``moe_train`` scenario on a ``gloo``
group of 4 CPU ranks; both from the reference's weights
(``repro_torch.convert.params_from_reference``), f32 compute and f32
parameters.  Cases, each on its own ``data × model`` mesh under
``make_ctx``:

* (2, 2) and (1, 4) through ``moe_ep`` (4 × 32 tokens): the router and the
  experts used whole on each rank's tokens, the aux's mean;
* (2, 2) with ``fsdp`` on: the experts' ``d_model`` dim over ``data``,
  gathered before use;
* (2, 2) with 2 × 6 tokens, fewer than ``4 × n_experts``: the sharded
  ``moe_dense``, each rank's experts summed over ``model``.

Bounds (``tests/test_torch_distributed_recurrent_train.py``'s): one
sharded ``value_and_grad``, the loss within 1e-5 relative and every
gradient leaf within 1e-4 × its max |value|; three AdamW steps at lr 3e-4
(warmup 2 of 10), each loss within 2e-3 and every parameter allclose
1e-3 (``tests/test_distributed.py:25-67``'s).
"""
import dataclasses
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

from repro.data.pipeline import random_batch
from repro_torch.convert import params_from_reference
from repro_torch.training.tree import flatten_with_paths
from torch_dist_ref import f32, leaves, ref_params
from torch_dist_worker import Ranks

SRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src")
MESHES = ("2x2/fsdp0/long", "1x4/fsdp0/long", "2x2/fsdp1/long",
          "2x2/fsdp0/few")
LR, STEPS = 3e-4, 3
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4

#: the reference's side: each case's sharded loss and gradients and its
#: steps, on 4 host devices (run with ``sys.argv[1:] = IN OUT``)
REFERENCE = """
import dataclasses, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro import configs
from repro.distribution.sharding import sharding_ctx
from repro.launch.mesh import make_ctx, make_test_mesh
from repro.models.transformer import build_model
from repro.training.optimizer import OptCfg, adamw_update
from repro.training.train import TrainState, init_train_state

data = dict(np.load(sys.argv[1]))
out = {}
for case in (str(c) for c in data["cases"]):
    arch, shape, fsdp, key = case.split("/")
    cfg = dataclasses.replace(configs.get_smoke(arch), dtype="float32",
                              param_dtype="float32", fsdp=fsdp == "fsdp1")
    tokens = jnp.asarray(data["tokens." + key])
    labels = jnp.asarray(data["labels." + key])
    like, tdef = jax.tree.flatten(jax.eval_shape(
        build_model(cfg).init, jax.random.key(0)))
    params = tdef.unflatten([jnp.asarray(data[f"j.{arch}/{i}"], l.dtype)
                             for i, l in enumerate(like)])
    mesh = make_test_mesh(tuple(int(a) for a in shape.split("x")),
                          ("data", "model"))
    with sharding_ctx(make_ctx(mesh, cfg)):
        model = build_model(cfg)
        shardings = jax.tree.map(lambda s: NamedSharding(mesh, s),
                                 model.param_specs(),
                                 is_leaf=lambda s: isinstance(s, P))
        pd = jax.tree.map(jax.device_put, params, shardings)
        ocfg = OptCfg(lr=float(data["lr"]), warmup_steps=2, total_steps=10)

        @jax.jit
        def step(state, tokens, labels):
            # build_train_step's step, which also hands out its gradients
            loss, g = jax.value_and_grad(model.loss)(state.params, tokens,
                                                     labels)
            new_p, new_opt, _ = adamw_update(ocfg, state.params, g,
                                             state.opt)
            return TrainState(new_p, new_opt, None), loss, g

        state = init_train_state(model, jax.random.key(0))._replace(params=pd)
        for i in range(int(data["steps"])):
            state, loss, grads = step(state, tokens, labels)
            out[f"{case}/loss{i}"] = np.float32(loss)
            if i == 0:
                out[f"{case}/grad/loss"], g = np.float32(loss), grads
    for name, tree in (("g", g), ("params", state.params)):
        for i, leaf in enumerate(jax.tree.leaves(tree)):
            out[f"{case}/{name}/{i}"] = np.asarray(leaf, np.float32)
np.savez(sys.argv[2], **out)
"""


def _f32(arch):
    """The smoke config with f32 compute and f32 parameters (the MoE smoke
    configs keep bf16 parameters, whose gradients round to 8 bits)."""
    return dataclasses.replace(f32(arch), param_dtype="float32")


def _batches():
    out = {}
    for key, (seed, b, s) in {"long": (0, 4, 32), "few": (1, 2, 6)}.items():
        out["tokens." + key], out["labels." + key] = random_batch(
            seed, b, s, 512)
    return out


def cases(arch):
    return [f"{arch}/{m}" for m in MESHES]


def run(arch, tmp):
    """``(rank outputs, the reference's outputs, (the reference's weights,
    the port's))`` of ``arch``'s cases: the ranks started first, the
    reference's subprocess while they work."""
    jp, tp, p = ref_params(arch, param_dtype="float32")
    inp = dict(_batches(), cases=np.array(cases(arch)), lr=np.float64(LR),
               steps=np.int64(STEPS))
    inp.update({f"p.{arch}/" + k[2:]: v for k, v in p.items()})
    inp.update({f"j.{arch}/{i}": np.asarray(leaf)
                for i, leaf in enumerate(jax.tree.leaves(jp))})
    ranks = Ranks("moe_train", 4, inp, tmp, timeout=400)
    ref_in, ref_out = str(tmp / "ref_in.npz"), str(tmp / "ref_out.npz")
    np.savez(ref_in, **inp)
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS=os.environ.get("XLA_FLAGS", "")
               + " --xla_force_host_platform_device_count=4")
    proc = subprocess.run([sys.executable, "-c", REFERENCE, ref_in, ref_out],
                          env=env, capture_output=True, text=True,
                          timeout=400)
    outs = ranks.wait()
    assert proc.returncode == 0, proc.stderr[-4000:]
    with np.load(ref_out) as f:
        return outs, dict(f), (jp, tp)


def _reference_tree(ref, prefix, arch, jp):
    """The reference's leaves under ``prefix`` as the port's tree's
    arrays, in the port's order."""
    jt = jax.tree.unflatten(jax.tree.structure(jp), [
        ref[f"{prefix}{i}"] for i in range(len(jax.tree.leaves(jp)))])
    return [leaf.float().numpy() for _, leaf in flatten_with_paths(
        params_from_reference(_f32(arch), jt, "cpu"))]


def check_grads(runs, case):
    outs, ref, (jp, tp) = runs
    arch = case.split("/")[0]
    r0 = outs[0]
    for r in outs:
        assert float(r[f"{case}/grad/loss"]) == float(r0[f"{case}/grad/loss"])
    assert float(r0[f"{case}/grad/loss"]) == pytest.approx(
        float(ref[f"{case}/grad/loss"]), rel=LOSS_TOL)
    paths = ["/".join(p) for p, _ in flatten_with_paths(tp)]
    want = _reference_tree(ref, f"{case}/g/", arch, jp)
    for path, got, w in zip(paths, leaves(r0, f"{case}/grad/g/", tp), want):
        gap = float(np.abs(got - w).max())
        assert gap <= GRAD_TOL * float(np.abs(w).max()), (path, gap)


def check_steps(runs, case):
    outs, ref, (jp, tp) = runs
    arch = case.split("/")[0]
    r0 = outs[0]
    assert any("Shard" in p for p in r0[f"{case}/placements"])
    if "fsdp1" in case:   # the experts' d_model dim over data
        assert "(Shard(dim=1), Shard(dim=0))" in r0[f"{case}/placements"]
    for i in range(STEPS):
        for r in outs:
            assert float(r[f"{case}/loss{i}"]) == float(r0[f"{case}/loss{i}"])
        assert abs(float(r0[f"{case}/loss{i}"])
                   - float(ref[f"{case}/loss{i}"])) < 2e-3
    want = _reference_tree(ref, f"{case}/params/", arch, jp)
    for got, w in zip(leaves(r0, f"{case}/params/", tp), want):
        np.testing.assert_allclose(got, w, rtol=1e-3, atol=1e-3)
