"""Training launcher of the port (counterpart of ``repro/launch/train.py``,
the same flags and printed line).

Builds the model for an assigned architecture, initialises its train
state from seed 0 and drives the fault-tolerant training loop on the
``lcg`` data (checkpoint every N steps, restart on failure).  It runs on
the card unless ``--device cpu`` is given.

``--mesh single|multi`` trains on the production mesh (16 × 16 ``data ×
model``, or 2 × 16 × 16 with a ``pod`` axis): one process a rank, started
by a launcher that sets ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` and
``MASTER_PORT`` (the process group is ``nccl`` on the card, ``gloo`` on
the CPU).  A world of another size stops before any step with
:class:`~repro_torch.launch.mesh.MeshSizeError`.  ``--compress-pods``
syncs the pods' gradients through the int8 error-feedback compressor; it
needs ``--mesh multi``.

    python -m repro_torch.launch.train --arch olmo-1b --steps 200
    python -m repro_torch.launch.train --smoke --device cpu --steps 60 \\
        --lr 1e-2 --batch 4 --seq 32

A directory that already holds checkpoints is resumed from its latest.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo-1b")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--mesh", choices=["none", "single", "multi"],
                    default="none")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--compress-pods", action="store_true",
                    help="int8 error-feedback cross-pod gradient sync")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    import contextlib

    import torch

    from repro_torch import configs
    from repro_torch.data.pipeline import make_data_iter
    from repro_torch.device import resolve_device
    from repro_torch.distribution.sharding import sharding_ctx
    from repro_torch.launch.mesh import make_ctx, make_production_mesh
    from repro_torch.models.transformer import build_model
    from repro_torch.training.checkpoint import CheckpointManager
    from repro_torch.training.optimizer import OptCfg
    from repro_torch.training.train import (build_train_step,
                                            build_train_step_compressed,
                                            init_train_state,
                                            run_with_restarts,
                                            shard_train_state)

    dev = resolve_device(args.device)
    cfg = configs.get_smoke(args.arch) if args.smoke else \
        configs.get(args.arch)
    ocfg = OptCfg(lr=args.lr, warmup_steps=min(50, args.steps // 10 + 1),
                  total_steps=args.steps)
    ctx = None
    if args.mesh != "none":
        _join_world(dev)
        mesh = make_production_mesh(multi_pod=args.mesh == "multi",
                                    device_type=dev.type)
        ctx = make_ctx(mesh, cfg)
    with sharding_ctx(ctx) if ctx is not None else contextlib.nullcontext():
        model = build_model(cfg, dev)
        state = init_train_state(model, torch.Generator(dev).manual_seed(0),
                                 compressed=args.compress_pods)
        make_step = (build_train_step_compressed if args.compress_pods
                     else build_train_step)
        step_fn = make_step(model, ocfg, microbatches=args.microbatches)
        if ctx is not None:
            state = shard_train_state(state, model, ctx)
        data = make_data_iter("lcg", args.batch, args.seq, cfg.vocab,
                              device=dev)
        mgr = CheckpointManager(args.ckpt_dir)
        t0 = time.time()
        state, rep = run_with_restarts(step_fn, state, data,
                                       n_steps=args.steps, ckpt_mgr=mgr,
                                       ckpt_every=args.ckpt_every)
    dt = time.time() - t0
    print(f"{rep.steps_done} steps in {dt:.0f}s; loss "
          f"{rep.losses[0]:.3f} → {rep.final_loss:.3f}; "
          f"restarts={rep.restarts}")


def _join_world(dev) -> None:
    """Join the process group a launcher described in the environment
    (``WORLD_SIZE`` > 1); a lone process stays a world of one."""
    import torch.distributed as dist
    if dist.is_initialized() or int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        return
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo")


if __name__ == "__main__":
    main()
