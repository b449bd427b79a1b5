"""Three-term roofline of the dry-run census's cells (counterpart of
``repro/roofline/analysis.py``).

Per (arch × shape × mesh) cell::

    compute    = FLOPs_per_device / peak_FLOP/s
    memory     = bytes_per_device / HBM_bw
    collective = in_node_bytes / NVLink_bw + cross_node_bytes / IB_bw
                 + cross_pod_bytes / IB_bw

(the census counts per device, so no further division by the number of
devices).  The terms are the census's at the full depth: its two-point
fit over ``unit`` and ``2 · unit`` layers (:func:`_unit`;
``repro_torch.launch.dryrun.run_cell``), with attention as
``xla_unrolled``, whose blocks skip the masked half of a causal score
matrix.

Hardware model: one NVIDIA H100 80GB HBM3 (SXM5, 700 W) a rank, eight to
a node over NVLink, nodes and pods joined by InfiniBand.  Every constant
below is a data-sheet figure, not a measurement of this port.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os

#: H100 SXM5 dense bf16 tensor-core peak, FLOP/s (data sheet)
H100_BF16_PEAK_FLOPS = 989e12
#: H100 SXM5 HBM3 bandwidth, bytes/s (data sheet)
H100_HBM_BW = 3.35e12
#: H100 SXM5 device memory, bytes (data sheet: 80 GB)
H100_HBM_BYTES = 80e9
#: NVLink 4 within an 8-GPU node: 900 GB/s total, 450 GB/s a direction
#: (data sheet)
H100_NVLINK_BW = 450e9
#: one 400 Gb/s InfiniBand NDR port a GPU across nodes and pods, 50 GB/s
#: (data sheet)
IB_NDR_BW = 50e9

PEAK_FLOPS = H100_BF16_PEAK_FLOPS
HBM_BW = H100_HBM_BW


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    # per-device totals for the real depth
    flops: float
    bytes_hbm: float
    coll_bytes: float
    coll_cross_pod: float
    # the three terms, in seconds
    t_compute: float
    t_memory: float
    t_collective: float
    bottleneck: str
    model_flops: float            # 6·N_active·tokens (train) / 2· (serve)
    useful_ratio: float           # MODEL_FLOPS / (FLOPs × devices)
    roofline_frac: float          # t_ideal_compute / max(terms)
    coll_cross_node: float = 0.0
    peak_memory_bytes: float = 0.0
    note: str = ""

    def row(self):
        return dataclasses.asdict(self)


def model_flops(cfg, shape_cfg) -> float:
    """Analytic matmul FLOPs: 6·N·D (train) or 2·N·D (forward-only)."""
    n_active = cfg.active_params()
    tokens = shape_cfg.global_batch * (
        shape_cfg.seq_len if shape_cfg.kind in ("train", "prefill") else 1)
    mult = 6.0 if shape_cfg.kind == "train" else 2.0
    return mult * n_active * tokens


def _unit(cfg) -> int:
    return cfg.hybrid_attn_every if cfg.family == "hybrid" and \
        cfg.hybrid_attn_every else 1


def devices(multi_pod: bool) -> int:
    return 512 if multi_pod else 256


def collective_seconds(total: float, cross_node: float,
                       cross_pod: float) -> float:
    """The collective term: the bytes that stay in a node over NVLink, the
    rest over InfiniBand (cross-pod bytes are cross-node bytes too)."""
    return ((total - cross_node) / H100_NVLINK_BW
            + (cross_node - cross_pod) / IB_NDR_BW + cross_pod / IB_NDR_BW)


def roofline_of(res) -> Roofline:
    """The roofline of a census cell (a ``CellResult`` at full depth)."""
    from repro_torch import configs
    from repro_torch.configs.shapes import SHAPES
    cfg = configs.get(res.arch)
    shape_cfg = SHAPES[res.shape]
    c = res.collectives
    coll, cn, cp = (c.get(k, 0.0) for k in ("total", "cross_node",
                                            "cross_pod"))
    chips = devices(res.mesh == "2x16x16")
    t_comp = res.flops / PEAK_FLOPS
    t_mem = res.bytes_accessed / HBM_BW
    t_coll = collective_seconds(coll, cn, cp)
    terms = {"compute": t_comp, "memory": t_mem, "collective": t_coll}
    bottleneck = max(terms, key=terms.get)
    mf = model_flops(cfg, shape_cfg)
    useful = mf / max(res.flops * chips, 1e-9)
    t_ideal = mf / chips / PEAK_FLOPS
    frac = t_ideal / max(max(terms.values()), 1e-12)
    return Roofline(
        arch=res.arch, shape=res.shape, mesh=res.mesh,
        flops=res.flops, bytes_hbm=res.bytes_accessed, coll_bytes=coll,
        coll_cross_pod=cp, t_compute=t_comp, t_memory=t_mem,
        t_collective=t_coll, bottleneck=bottleneck, model_flops=mf,
        useful_ratio=useful, roofline_frac=frac, coll_cross_node=cn,
        peak_memory_bytes=res.peak_memory_bytes)


def roofline_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
                  rule_overrides: dict | None = None,
                  cfg_overrides: dict | None = None,
                  attn_impl: str = "xla_unrolled") -> Roofline | None:
    """Two traces (``unit`` and ``2 · unit`` layers) → the affine per-layer
    cost at the full depth → the roofline; ``None`` for a cell the shape
    does not apply to."""
    from repro_torch.launch.dryrun import run_cell
    r = run_cell(arch, shape_name, multi_pod=multi_pod, attn_impl=attn_impl,
                 rule_overrides=rule_overrides, cfg_overrides=cfg_overrides)
    if r.status == "skip":
        return None
    if r.status != "ok":
        raise RuntimeError(f"roofline trace failed: {r.reason}")
    return roofline_of(r)


def fmt_row(r: Roofline) -> str:
    return (f"{r.arch:18s} {r.shape:12s} {r.mesh:8s} "
            f"comp={r.t_compute*1e3:9.3f}ms mem={r.t_memory*1e3:9.3f}ms "
            f"coll={r.t_collective*1e3:9.3f}ms -> {r.bottleneck:10s} "
            f"useful={r.useful_ratio:6.3f} roofline={r.roofline_frac:6.3f}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--from-dryrun", metavar="JSON",
                    help="the rows of a census already run "
                         "(python -m repro_torch.launch.dryrun --all), "
                         "both meshes, instead of tracing again")
    ap.add_argument("--out", default="experiments/roofline.json")
    args = ap.parse_args(argv)
    from repro_torch import configs
    from repro_torch.configs.shapes import SHAPES
    rows = []
    if args.from_dryrun:
        from repro_torch.launch.dryrun import CellResult
        with open(args.from_dryrun) as f:
            cells = [CellResult(**r) for r in json.load(f)]
        for c in cells:
            if c.status == "ok":
                r = roofline_of(c)
                print(fmt_row(r), flush=True)
                rows.append(r.row())
            else:
                print(f"{c.arch:18s} {c.shape:12s} {c.mesh:8s} "
                      f"{c.status.upper()} {c.reason[:60]}", flush=True)
    else:
        cells = ([(a, s) for a in configs.ARCH_NAMES for s in SHAPES]
                 if args.all else [(args.arch, args.shape)])
        for arch, shape in cells:
            try:
                r = roofline_cell(arch, shape, multi_pod=args.multi_pod)
            except RuntimeError as e:
                print(f"{arch:18s} {shape:12s} FAIL {e}", flush=True)
                continue
            if r is None:
                print(f"{arch:18s} {shape:12s} SKIP (inapplicable)",
                      flush=True)
                continue
            print(fmt_row(r), flush=True)
            rows.append(r.row())
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)


if __name__ == "__main__":
    main()
