#!/usr/bin/env python3
"""The f32 floor under phase 22c's rwkv6-3b gradient check, on the card.

    python3 tools/recurrent_grad_floor.py

Builds the kernels, then on two rank processes over ``gloo`` (the
(data 1 × model 2) mesh of ``chip_smoke.py`` phases 21-22) takes 22c's
rwkv6-3b (published widths, 2 layers, f32, the 2 × 64 ``lcg`` batch)
from two sets of weights of seed 11: drawn by the card's generator (what
phase 22 runs) and by the host's.  For each it prints, over the
gradient leaves, each rank's largest gaps of the sharded gradients to
the one-device run's (over the leaf's max |value|, 22c's measure), beside
how far the one-device run moves from itself when every scan region's
inputs (``r``, ``k``, ``v``, ``lw``, ``g``) move by a relative 1e-7 and
5e-7 at random (the size of the rounding the sharded products leave
there) and when the scan's chunk is 16 instead of 32.  A sharded gap at
the size of the perturbed runs' is rounding that the model amplifies, not
a fault of the sharded path.
"""
from __future__ import annotations

import datetime
import multiprocessing as mp
import socket
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

PERTURB = (1e-7, 5e-7)


def _rank(r, port, q):
    import dataclasses

    import torch
    import torch.distributed as dist
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=2, rank=r,
                            timeout=datetime.timedelta(seconds=300))
    import chip_smoke as cs
    from repro_torch.data.pipeline import lcg_batch, place
    from repro_torch.distribution import sharding as sh
    from repro_torch.launch.mesh import make_ctx, make_test_mesh
    from repro_torch.models import rwkv6
    from repro_torch.models.transformer import build_model
    from repro_torch.training.train import value_and_grad
    from repro_torch.training.tree import (flatten_with_paths, tree_leaves,
                                           unflatten_like)

    def ratio(a, b):
        scale = float(b.abs().max())
        gap = float((a - b).abs().max())
        return gap / scale if scale else gap

    mesh = make_test_mesh((1, 2), ("data", "model"), device_type="cuda")
    arch, n_layers = "rwkv6-3b", 2
    res = {}
    for source in ("card", "host"):
        cfg = cs._published(arch, n_layers=n_layers, dtype="float32",
                            attn_impl=cs._published(arch).attn_impl)
        dev = "cpu" if source == "host" else "cuda"
        params = build_model(cfg, dev).init(
            torch.Generator(dev).manual_seed(cs.SHARD_SEED))
        params = unflatten_like(params, [t.to("cuda")
                                         for t in tree_leaves(params)])
        model = build_model(cfg, "cuda")
        tokens, labels = place(*lcg_batch(0, cs.CHECK_BATCH, cs.CHECK_SEQ,
                                          cfg.vocab), device="cuda")
        with sh.sharding_ctx(make_ctx(mesh, cfg)):
            pd = sh.param_sharding_tree(params, model.param_specs(), mesh)
            with sh.plain_as_replicated():
                _, g = value_and_grad(model.loss, pd, tokens, labels)
        want = value_and_grad(model.loss, params, tokens, labels)[1]
        rows = {}
        for (path, a), b in zip(flatten_with_paths(g), tree_leaves(want)):
            if b.numel():
                rows["/".join(path)] = {"sharded": ratio(*cs._shard_pair(
                    a, b))}
        wd = {"/".join(p): t for p, t in flatten_with_paths(want)}
        orig = rwkv6._wkv_heads
        for rel in PERTURB:
            gen = torch.Generator("cuda").manual_seed(5)

            def moved(K, *args, rel=rel, gen=gen):
                args = list(args)
                for i in range(5):
                    args[i] = args[i] * (1 + rel * torch.randn(
                        args[i].shape, generator=gen, device="cuda"))
                return orig(K, *args)
            rwkv6._wkv_heads = moved
            try:
                other = value_and_grad(model.loss, params, tokens, labels)[1]
            finally:
                rwkv6._wkv_heads = orig
            for p, t in flatten_with_paths(other):
                if "/".join(p) in rows:
                    rows["/".join(p)][f"moved {rel:g}"] = ratio(
                        t, wd["/".join(p)])
        cfg16 = dataclasses.replace(cfg, rwkv=dataclasses.replace(
            cfg.rwkv, chunk=16))
        other = value_and_grad(build_model(cfg16, "cuda").loss, params,
                               tokens, labels)[1]
        for p, t in flatten_with_paths(other):
            if "/".join(p) in rows:
                rows["/".join(p)]["chunk 16"] = ratio(t, wd["/".join(p)])
        res[source] = rows
        del params, pd, g, want, other
        torch.cuda.empty_cache()
    q.put((r, res))
    dist.destroy_process_group()


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("recurrent_grad_floor: no CUDA device; this runs on the card",
              file=sys.stderr)
        return 2
    import chip_smoke as cs
    cs.build({})
    ctx = mp.get_context("spawn")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    q = ctx.Queue()
    procs = [ctx.Process(target=_rank, args=(r, port, q)) for r in range(2)]
    for p in procs:
        p.start()
    try:
        out = dict(q.get(timeout=300) for _ in procs)
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
    cols = ["sharded", *(f"moved {rel:g}" for rel in PERTURB), "chunk 16"]
    for source in ("card", "host"):
        print(f"rwkv6-3b, 2 layers, weights from the {source}'s generator, "
              f"seed {cs.SHARD_SEED}: gap / leaf max")
        for r in sorted(out):
            rows = out[r][source]
            worst = sorted(rows, key=lambda k: -rows[k]["sharded"])[:5]
            print(f"  rank {r}, max over {len(rows)} leaves: " + ", ".join(
                f"{c} {max(v[c] for v in rows.values()):.3e}" for c in cols))
            for k in worst:
                print(f"    {k}: " + ", ".join(
                    f"{c} {rows[k][c]:.3e}" for c in cols))
    return 0


if __name__ == "__main__":
    sys.exit(main())
