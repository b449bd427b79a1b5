"""The port's sharded gradients and AdamW step of the recurrent families
(``rwkv6``, ``hybrid``) on a (2, 2) ``data × model`` ``gloo`` group of 4
CPU ranks, against the reference's single-device run from the same
weights (``repro_torch.convert.params_from_reference``; the JAX side runs
with x64 off, as ``tests/test_torch_training.py`` runs it).

* one sharded ``value_and_grad`` of rwkv6-3b's and zamba2-2.7b's f32
  smoke configs, parameters laid out by their specs, against
  ``jax.value_and_grad``: the loss within 1e-5 relative and every
  gradient leaf within 1e-4 × its max |value| (the port's f32 gradient
  bound, ``tests/test_torch_training.py``; measured at most 3.4e-5).  The
  scans' gradients pass through ``ScanGrad`` on each rank's local heads,
  and the inputs a region uses whole on its part of the batch (``bonus``,
  the group norm's scale, ``a``, ``d_skip``) must come back summed over
  ``data``: a missing sum halves a leaf, far beyond the bound;
* one sharded AdamW step (lr 1e-2, warmup 2 of 10, the reference test's
  ``OptCfg``, ``tests/test_distributed.py:25-67``) against the
  reference's ``adamw_update`` on its own gradients: the loss within 2e-3
  of the reference's and of the port's one-device step, and every
  parameter allclose 1e-3 of the reference's.  The first step moves each
  parameter by ``lr/2 × g / (|g| + eps)``, 5e-3 wherever the clipped
  gradient is well above eps, so a leaf whose gradient is zero or of the
  wrong sign fails.  A step cannot see a wrong scale (AdamW divides it
  out): the gradient test does.  At three steps rwkv6's runs part by a
  few elements in 16 384 (ROADMAP Queue 3).

The world's rendezvous and every collective time out after 90 s, the
world after 150 s (``tests/torch_dist_worker.py``); it starts before the
reference runs here.
"""
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.data.pipeline import random_batch
from repro.models import transformer as jtr
from repro.training import optimizer as jopt
from repro_torch.convert import params_from_reference
from repro_torch.training.tree import flatten_with_paths
from torch_dist_ref import f32, leaves, ref_params
from torch_dist_worker import Ranks

RECURRENT = ("rwkv6-3b", "zamba2-2.7b")
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
#: the reference test's optimizer, one step
LR = 1e-2
OPT = dict(lr=LR, warmup_steps=2, total_steps=10)


def _reference(arch, jp, tokens, labels):
    """The reference's loss, gradients and first AdamW step from ``jp``,
    the trees as the port's trees of CPU tensors."""
    with jax.enable_x64(False):
        model = jtr.build_model(f32(arch, True))
        loss, grads = jax.jit(jax.value_and_grad(model.loss))(
            jp, jnp.asarray(tokens), jnp.asarray(labels))
        new, _, _ = jopt.adamw_update(jopt.OptCfg(**OPT), jp, grads,
                                      jopt.init_opt_state(jp))
        return float(loss), *(
            params_from_reference(f32(arch), jax.tree.map(np.asarray, t),
                                  "cpu") for t in (grads, new))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """``(rank outputs, {arch: (loss, grads, stepped params)}, {arch: the
    port's parameter tree})``: the ranks started first, the reference run
    while they work (its compiles in threads, each with x64 off)."""
    tokens, labels = random_batch(0, 4, 32, 512)
    inp, jps, tps = {}, {}, {}
    with ThreadPoolExecutor(len(RECURRENT)) as pool:
        for arch, (jp, tp, p) in zip(RECURRENT, pool.map(
                lambda a: ref_params(a, jit=True), RECURRENT)):
            jps[arch], tps[arch] = jp, tp
            inp.update({f"p.{arch}/" + k[2:]: v for k, v in p.items()})
    ranks = Ranks("recurrent_train", 4, dict(
        inp, archs=np.array(",".join(RECURRENT)), tokens=tokens,
        labels=labels, lr=np.float64(LR), steps=np.int64(1)),
        tmp_path_factory.mktemp("world4"))
    with ThreadPoolExecutor(len(RECURRENT)) as pool:
        ref = dict(zip(RECURRENT, pool.map(
            lambda a: _reference(a, jps[a], tokens, labels), RECURRENT)))
    return ranks.wait(), ref, tps


def _tree(t):
    return [leaf.numpy() for _, leaf in flatten_with_paths(t)]


@pytest.mark.parametrize("arch", RECURRENT)
def test_sharded_recurrent_grads_match_reference(runs, arch):
    outs, ref, tps = runs
    loss, grads, _ = ref[arch]
    k = f"grad.{arch}/"
    r0 = outs[0]
    for r in outs:
        assert float(r[k + "loss"]) == float(r0[k + "loss"])
    assert float(r0[k + "loss"]) == pytest.approx(loss, rel=LOSS_TOL)
    paths = ["/".join(p) for p, _ in flatten_with_paths(tps[arch])]
    for path, got, want in zip(paths, leaves(r0, k + "g/", tps[arch]),
                               _tree(grads)):
        gap = float(np.abs(got - want).max())
        assert gap <= GRAD_TOL * float(np.abs(want).max()), (path, gap)


@pytest.mark.parametrize("arch", RECURRENT)
def test_sharded_recurrent_train_step(runs, arch):
    outs, ref, tps = runs
    loss, _, new = ref[arch]
    k = f"train.{arch}/"
    r0 = outs[0]
    assert any("Shard" in p for p in r0[k + "placements"])
    for r in outs:
        assert float(r[k + "loss0"]) == float(r0[k + "loss0"])
    assert abs(float(r0[k + "loss0"]) - loss) < 2e-3
    assert abs(float(r0[k + "loss0"]) - float(r0[k + "single_loss0"])) < 2e-3
    for got, want in zip(leaves(r0, k + "sharded/", tps[arch]), _tree(new)):
        np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)
