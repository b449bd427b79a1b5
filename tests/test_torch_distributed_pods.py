"""The port's compressed cross-pod train step on a real (2, 2, 2) ``pod
× data × model`` group of ``gloo`` ranks on the CPU (the counterpart of
``tests/test_distributed.py:98-122``).

* the loss falls over 5 steps and ends within 0.25 of the exact step's
  on the same mesh (the reference test's bounds; that test itself fails
  on the reference side);
* the exact step's losses are within 2e-3 of the reference's
  single-device step from the same weights;
* each pod's state lives on its own ``data × model`` submesh;
* the first update equals AdamW applied to the int8 error-feedback sync
  of the two pods' gradients (numpy's arithmetic of the sync) within
  1e-6 × max |p|, and each pod's new error equals numpy's bit for bit.
"""
import numpy as np
import torch

from repro.data.pipeline import random_batch
from repro_torch.training.optimizer import (OptCfg, adamw_update,
                                            init_opt_state)
from repro_torch.training.tree import flatten_with_paths, unflatten_like
from torch_dist_ref import leaves as _leaves
from torch_dist_ref import ref_params as _ref_params
from torch_dist_ref import ref_steps as _ref_steps
from torch_dist_worker import Ranks


def _numpy_sync(xs):
    """The int8 error-feedback sync's arithmetic in numpy on the members'
    ``g + err``: (the synced mean, each member's new error)."""
    if not xs[0].size:                 # placeholder leaves pass through
        return xs[0], list(xs)
    scale = max(np.float32(max(np.abs(x).max(), np.float32(1e-12)))
                / np.float32(127.0) for x in xs)
    qs = [np.clip(np.rint(x / scale), -127, 127).astype(np.int8) for x in xs]
    errs = [x - q.astype(np.float32) * scale for x, q in zip(xs, qs)]
    total = sum(q.astype(np.int32) for q in qs)
    return total.astype(np.float32) * scale / np.float32(len(xs)), errs


def test_compressed_step_on_pods(tmp_path):
    ocfg = OptCfg(lr=5e-3, warmup_steps=2, total_steps=20)
    tokens, labels = random_batch(0, 4, 32, 512)
    jp, tp, inp = _ref_params("olmo-1b")
    ranks = Ranks("compressed", 8, dict(inp, tokens=tokens, labels=labels),
                  tmp_path)
    ref_losses, _ = _ref_steps("olmo-1b", ocfg, jp, tokens, labels, 5)
    outs = ranks.wait()
    r0 = outs[0]
    lc = [float(r0[f"loss_c{i}"]) for i in range(5)]
    le = [float(r0[f"loss_e{i}"]) for i in range(5)]
    print("compressed", lc, "\nexact     ", le, "\nreference ", ref_losses)
    assert lc[-1] < lc[0]                      # converging
    assert abs(lc[-1] - le[-1]) < 0.25
    for a, b in zip(le, ref_losses):
        assert abs(a - b) < 2e-3
    # each pod's parameters live on its own data × model submesh
    assert all(p.startswith("('data', 'model')") for p in r0["placements"])
    # the first update: AdamW on the sync of the two pods' gradients
    pods = {int(r["pod"]): r for r in outs}
    assert sorted(pods) == [0, 1]
    grads = [_leaves(pods[k], "pod_grads/", tp) for k in (0, 1)]
    synced, errs = zip(*[_numpy_sync([g0, g1])
                         for g0, g1 in zip(*grads)])
    want, _, _ = adamw_update(
        ocfg, tp, unflatten_like(tp, [torch.from_numpy(g) for g in synced]),
        init_opt_state(tp))
    for (path, w), got in zip(flatten_with_paths(want),
                              _leaves(r0, "step1/", tp)):
        if not w.numel():
            continue
        scale = float(w.abs().max())
        assert np.abs(got - w.numpy()).max() <= 1e-6 * scale, path
    for k in (0, 1):
        for e, got in zip([e[k] for e in errs],
                          _leaves(pods[k], "err1/", tp)):
            np.testing.assert_array_equal(got, e)
