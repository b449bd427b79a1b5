"""The f32 spread of a model's gradients on the CPU against itself.

One training step's loss and gradients of ``--arch`` at published widths,
cut to ``--layers``, in f32 from ``--seed`` on the lcg batch of step 0
(``--batch`` × ``--seq``), computed twice on the CPU with two intra-op
thread counts: the same program, only the summation order of the
matrix products differs.  Prints the largest gaps, each as max |a − b| ÷
max |b| over a gradient leaf: the floor below which no comparison of
two f32 runs of this model can hold (``chip_smoke.py`` phase 19b holds
the card against the CPU).

    PYTHONPATH=src python tools/train_grad_noise.py --arch rwkv6-3b \\
        --layers 2
"""
from __future__ import annotations

import argparse
import dataclasses


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="rwkv6-3b")
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--threads", type=int, nargs=2, default=(2, 3))
    ap.add_argument("--top", type=int, default=5)
    args = ap.parse_args(argv)

    import torch

    from repro_torch import configs
    from repro_torch.data.pipeline import lcg_batch
    from repro_torch.models.transformer import build_model
    from repro_torch.training.train import value_and_grad
    from repro_torch.training.tree import flatten_with_paths

    cfg = dataclasses.replace(configs.get(args.arch), n_layers=args.layers,
                              dtype="float32", remat="none")
    model = build_model(cfg, "cpu")
    params = model.init(torch.Generator().manual_seed(args.seed))
    tokens, labels = (torch.from_numpy(a) for a in
                      lcg_batch(0, args.batch, args.seq, cfg.vocab))
    runs = []
    for n in args.threads:
        torch.set_num_threads(n)
        loss, grads = value_and_grad(model.loss, params, tokens, labels)
        runs.append((float(loss), {"/".join(p): g for p, g in
                                   flatten_with_paths(grads)}))
    (la, a), (lb, b) = runs
    gaps = sorted(
        ((a[k] - b[k]).abs().max().item() / b[k].abs().max().item(), k)
        for k in b if b[k].numel() and b[k].abs().max() > 0)
    print(f"{args.arch} at {args.layers} layers, {args.threads[0]} against "
          f"{args.threads[1]} threads: loss {la!r} / {lb!r}; largest "
          f"gradient gaps (x max |leaf|):")
    for gap, key in gaps[::-1][:args.top]:
        print(f"  {gap:.3e}  {key}")


if __name__ == "__main__":
    main()
