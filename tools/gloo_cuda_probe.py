#!/usr/bin/env python3
"""What gloo carries between two ranks that share one CUDA card.

    python3 tools/gloo_cuda_probe.py

Starts two rank processes on device 0 over a ``gloo`` group (NCCL
refuses two ranks on one device) and tries, on CUDA tensors: c10d's
``all_reduce``, ``all_gather_into_tensor``, ``reduce_scatter_tensor`` and
``all_to_all_single``; torch's functional all-gather (what DTensor's
``Shard`` → ``Replicate`` redistribution calls), in a rank pair of its own
because it may kill the process; and DTensor's redistributions with the
functional collectives routed through c10d's
(``repro_torch.distribution.sharding.route_functional_collectives``).
Prints one JSON object: each probe's result, the card's name and power
limit, torch's version.  Exits non-zero without a card.
"""
from __future__ import annotations

import json
import socket
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _rank(rank: int, port: int, what: str) -> dict:
    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(ROOT / "src"))
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=2, rank=rank)
    dev = torch.device("cuda", 0)
    x = torch.arange(8, dtype=torch.float32, device=dev) + 10 * rank
    out = {}

    def probe(name, fn):
        try:
            fn()
            out[name] = "ok"
        except Exception as e:                            # noqa: BLE001
            out[name] = f"{type(e).__name__}: {e}"[:300]

    if what == "c10d":
        probe("all_reduce", lambda: dist.all_reduce(x.clone()))
        probe("all_gather_into_tensor", lambda: dist.all_gather_into_tensor(
            torch.empty(16, device=dev), x))
        probe("reduce_scatter_tensor", lambda: dist.reduce_scatter_tensor(
            torch.empty(4, device=dev), x))
        probe("all_to_all_single", lambda: dist.all_to_all_single(
            torch.empty(8, device=dev), x))
    elif what == "functional":
        import torch.distributed._functional_collectives as fc
        probe("functional all_gather_tensor", lambda: fc.all_gather_tensor(
            x, 0, dist.group.WORLD).wait())
    else:
        from torch.distributed.device_mesh import DeviceMesh
        from torch.distributed.tensor import (Replicate, Shard,
                                              distribute_tensor)

        from repro_torch.distribution.sharding import \
            route_functional_collectives
        route_functional_collectives()
        mesh = DeviceMesh("cuda", torch.arange(2), mesh_dim_names=("model",))
        a = torch.randn(64, 128, device=dev,
                        generator=torch.Generator(dev).manual_seed(0))

        def moves(src, dst):
            def run():
                d = distribute_tensor(a, mesh, [src], src_data_rank=None)
                got = d.redistribute(mesh, [dst]).full_tensor()
                assert torch.equal(got, a), "values"
            return run

        probe("Shard(0) -> Replicate", moves(Shard(0), Replicate()))
        probe("Shard(0) -> Shard(1)", moves(Shard(0), Shard(1)))
        probe("Replicate -> Shard(0)", moves(Replicate(), Shard(0)))
    dist.destroy_process_group()
    return out


def _pair(what: str) -> list:
    """Run probe set ``what`` on two rank processes: each rank's results,
    or its exit code if it died."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = [subprocess.Popen(
        [sys.executable, __file__, "--rank", str(r), str(port), what],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        for r in range(2)]
    out = []
    for p in procs:
        try:
            stdout, _ = p.communicate(timeout=120)
        except subprocess.TimeoutExpired:
            p.kill()
            stdout, _ = p.communicate()
        lines = stdout.strip().splitlines()
        out.append(json.loads(lines[-1]) if p.returncode == 0 and lines
                   else {"exit": p.returncode})
    return out


def main() -> int:
    if len(sys.argv) == 5 and sys.argv[1] == "--rank":
        print(json.dumps(_rank(int(sys.argv[2]), int(sys.argv[3]),
                               sys.argv[4])))
        return 0
    import torch
    if not torch.cuda.is_available():
        print("gloo_cuda_probe: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    report = {"card": smi.stdout.strip(), "torch": torch.__version__}
    for what in ("c10d", "functional", "dtensor routed"):
        report[what] = _pair(what.split()[0])
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
