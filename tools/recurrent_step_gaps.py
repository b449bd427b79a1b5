#!/usr/bin/env python3
"""How far the recurrent families' AdamW steps part on the CPU.

    JAX_PLATFORMS=cpu PYTHONPATH=src python tools/recurrent_step_gaps.py [--steps 3] [--lr 1e-2]

Runs ``tests/torch_dist_worker.py``'s ``recurrent_train`` scenario (a
sharded ``value_and_grad`` and ``--steps`` AdamW steps of rwkv6-3b's and
zamba2-2.7b's f32 smoke configs on a (2, 2) ``gloo`` group of 4 CPU
ranks, rank 0 also the port's one-device steps) beside the reference's
``jax.value_and_grad`` and steps from the same weights, and prints for
each pair of runs (sharded, one-device, reference) the losses and the
elements of the parameters beyond ``allclose(rtol=atol=1e-3)``, with the
worst ``|gap| - 1e-3 |want|`` and the reference's clipped first moment
there; and the reference against itself from every weight one ulp up
(its own rounding spread over the same steps).
``tests/test_torch_distributed_recurrent_train.py`` holds one step and
``tests/test_torch_recurrent_step_spread.py`` three, within twice that
spread.
"""
from __future__ import annotations

import argparse
import sys
import tempfile
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "tests"), str(ROOT / "src")]

ARCHS = ("rwkv6-3b", "zamba2-2.7b")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--lr", type=float, default=1e-2)
    args = ap.parse_args(argv)
    import jax
    import jax.numpy as jnp

    from repro.data.pipeline import random_batch
    from repro.models import transformer as jtr
    from repro.training import optimizer as jopt
    from repro.training import train as jtrain
    from repro_torch.convert import params_from_reference
    from repro_torch.training.tree import flatten_with_paths
    from torch_dist_ref import f32, leaves, ref_params
    from torch_dist_worker import Ranks

    tokens, labels = random_batch(0, 4, 32, 512)
    inp, jps, tps = {}, {}, {}
    for arch in ARCHS:
        jps[arch], tps[arch], p = ref_params(arch, jit=True)
        inp.update({f"p.{arch}/" + k[2:]: v for k, v in p.items()})
    with tempfile.TemporaryDirectory() as tmp:
        ranks = Ranks("recurrent_train", 4, dict(
            inp, archs=np.array(",".join(ARCHS)), tokens=tokens,
            labels=labels, lr=np.float64(args.lr),
            steps=np.int64(args.steps)), tmp, timeout=600)
        ref = {}
        for arch in ARCHS:
            with jax.enable_x64(False):
                model = jtr.build_model(f32(arch, True))
                state = jtrain.init_train_state(model, jax.random.key(0))
                state = state._replace(params=jps[arch])
                step = jax.jit(jtrain.build_train_step(model, jopt.OptCfg(
                    lr=args.lr, warmup_steps=2, total_steps=10)))
                losses, m1 = [], None
                for _ in range(args.steps):
                    state, m = step(state, jnp.asarray(tokens),
                                    jnp.asarray(labels))
                    losses.append(float(m["loss"]))
                    m1 = m1 or jax.tree.map(np.asarray, state.opt.m)
                # the reference against itself: every weight one ulp up
                up = jtrain.init_train_state(model, jax.random.key(0))
                up = up._replace(params=jax.tree.map(
                    lambda x: jnp.asarray(np.nextafter(
                        np.asarray(x), np.float32(np.inf))), jps[arch]))
                for _ in range(args.steps):
                    up, _ = step(up, jnp.asarray(tokens),
                                 jnp.asarray(labels))
                ref[arch] = losses, *(
                    [leaf.numpy() for _, leaf in flatten_with_paths(
                        params_from_reference(f32(arch), jax.tree.map(
                            np.asarray, t), "cpu"))]
                    for t in (state.params, m1, up.params))
        r0 = ranks.wait()[0]
    for arch in ARCHS:
        k, tp = f"train.{arch}/", tps[arch]
        losses, ref_p, ref_m1, ref_up = ref[arch]
        paths = ["/".join(p) for p, _ in flatten_with_paths(tp)]
        runs = {"sharded": leaves(r0, k + "sharded/", tp),
                "one-device": leaves(r0, k + "single/", tp),
                "reference": ref_p, "reference one ulp up": ref_up}
        print(f"{arch}, {args.steps} steps at lr {args.lr:g}: losses sharded "
              f"{[float(r0[f'{k}loss{i}']) for i in range(args.steps)]}, "
              f"one-device "
              f"{[float(r0[f'{k}single_loss{i}']) for i in range(args.steps)]}"
              f", reference {losses}")
        for a, b in (("sharded", "one-device"), ("sharded", "reference"),
                     ("one-device", "reference"),
                     ("reference one ulp up", "reference")):
            n, worst = 0, (-np.inf, None)
            gap = max(float(np.abs(x - y).max())
                      for x, y in zip(runs[a], runs[b]))
            for path, got, want, m1 in zip(paths, runs[a], runs[b], ref_m1):
                exc = np.abs(got - want) - 1e-3 * np.abs(want)
                n += int((exc > 1e-3).sum())
                i = np.unravel_index(np.argmax(exc), exc.shape)
                if exc[i] > worst[0]:
                    worst = (float(exc[i]), f"{path}{list(map(int, i))}, "
                             f"first moment {m1[i]:.3e} (leaf max "
                             f"{np.abs(m1).max():.3e})")
            print(f"  {a} vs {b}: max |gap| {gap:.3e}; {n} elements beyond "
                  f"allclose 1e-3; worst excess {worst[0]:.3e} at {worst[1]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
