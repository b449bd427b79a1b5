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
  port's one-device run and of the reference's;
* the elastic re-mesh: gemma-2b's smoke parameters laid out on (2, 4),
  saved, restored onto (4, 2): bit for bit, on the new mesh's
  placements.
"""
import numpy as np

from repro.data.pipeline import random_batch
from repro_torch.training.optimizer import OptCfg
from repro_torch.training.tree import flatten_with_paths
from torch_dist_ref import leaves as _leaves
from torch_dist_ref import ref_params as _ref_params
from torch_dist_ref import ref_steps as _ref_steps
from torch_dist_worker import Ranks


def test_sharded_train_matches_single_device(tmp_path):
    ocfg = OptCfg(lr=1e-2, warmup_steps=2, total_steps=10)
    tokens, labels = random_batch(0, 4, 32, 512)
    jp, tp, inp = _ref_params("olmo-1b")
    ranks = Ranks("train", 4, dict(inp, tokens=tokens, labels=labels),
                  tmp_path)
    ref_losses, ref_params = _ref_steps("olmo-1b", ocfg, jp, tokens, labels,
                                        3)
    outs = ranks.wait()
    r0 = outs[0]
    print("losses", [float(r0[f"loss{i}"]) for i in range(3)],
          "single", [float(r0[f"single_loss{i}"]) for i in range(3)],
          "reference", ref_losses)
    # the parameters are laid out over both axes, not replicated
    assert any("Shard" in p for p in r0["placements"])
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
