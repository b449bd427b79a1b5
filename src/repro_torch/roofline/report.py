"""Roofline report: derived metrics and a markdown table from
``roofline.json`` (counterpart of ``repro/roofline/report.py``).

Adds the *bandwidth* roofline fraction: decode steps are intrinsically
memory-bound (arithmetic intensity ≈ 1 flop/byte), so grading them
against peak FLOP/s alone is meaningless.  We compute an analytic
lower bound on HBM traffic per device:

* train   — parameter-system traffic: params(read+write) + grads +
            fp32 moments (read+write): ≈ (4·p_bytes + 16)·N/chips,
            plus token activations through the stack once.
* prefill — active params read (bf16) + KV/state cache write.
* decode  — active params read + full cache read per token.

``bw_frac   = t_min_bytes / max(term)`` — how close the dominant term is
to the analytic traffic floor;
``comp_frac = t_ideal_flops / max(term)`` — the classic MFU-style bound;
``roofline_frac = max(comp, bw)`` is the reported score per cell.

Each row also carries the census's per-device peak against the H100's
80 GB (``fits``).  The peaks, bandwidths and memory are data-sheet
figures (:mod:`repro_torch.roofline.analysis`).

    python -m repro_torch.roofline.report [--json experiments/roofline.json]
"""
from __future__ import annotations

import argparse
import json

from repro_torch.roofline.analysis import (H100_HBM_BYTES, HBM_BW,
                                           PEAK_FLOPS, devices)


def _cache_bytes(cfg, shape) -> float:
    B, S = shape.global_batch, shape.seq_len
    if cfg.family == "rwkv6":
        H = cfg.d_model // cfg.rwkv.head_size
        K = cfg.rwkv.head_size
        return cfg.n_layers * B * (H * K * K * 4 + 2 * cfg.d_model * 2)
    if cfg.family == "hybrid":
        s = cfg.ssm
        d_in = s.expand * cfg.d_model
        Hs = d_in // s.head_dim
        ssm = cfg.n_layers * B * (Hs * s.head_dim * s.d_state * 4
                                  + (s.conv_width - 1)
                                  * (d_in + 2 * s.d_state) * 2)
        n_attn = cfg.n_layers // cfg.hybrid_attn_every \
            if cfg.hybrid_attn_every else 0
        kv = n_attn * B * S * cfg.n_kv_heads * cfg.head_dim * 2 * 2
        return ssm + kv
    if cfg.mla is not None:
        return cfg.n_layers * B * S * (cfg.mla.kv_lora
                                       + cfg.mla.qk_rope) * 2
    return cfg.n_layers * B * S * cfg.n_kv_heads * cfg.head_dim * 2 * 2


def min_bytes(cfg, shape, chips: int) -> float:
    n_act = cfg.active_params()
    p_bytes = 2 if cfg.param_dtype == "bfloat16" else 4
    tokens = shape.global_batch * (shape.seq_len
                                   if shape.kind != "decode" else 1)
    act_stream = tokens * cfg.d_model * cfg.n_layers * 2 * 2  # r+w, bf16
    if shape.kind == "train":
        total = n_act * (4 * p_bytes + 16) + 3 * act_stream
    elif shape.kind == "prefill":
        total = n_act * 2 + _cache_bytes(cfg, shape) + act_stream
    else:
        total = n_act * 2 + _cache_bytes(cfg, shape) + act_stream
    return total / chips


def enrich(row: dict) -> dict:
    from repro_torch import configs
    from repro_torch.configs.shapes import SHAPES
    cfg = configs.get(row["arch"])
    shape = SHAPES[row["shape"]]
    chips = devices(row["mesh"] == "2x16x16")
    t_max = max(row["t_compute"], row["t_memory"], row["t_collective"])
    mb = min_bytes(cfg, shape, chips)
    t_bw = mb / HBM_BW
    comp_frac = (row["model_flops"] / chips / PEAK_FLOPS) / t_max
    bw_frac = t_bw / t_max
    out = dict(row)
    out.update(min_bytes_dev=mb, t_bw_ideal=t_bw,
               comp_frac=comp_frac, bw_frac=bw_frac,
               roofline_frac=max(comp_frac, bw_frac),
               fits=row.get("peak_memory_bytes", 0.0) <= H100_HBM_BYTES)
    return out


def to_markdown(rows) -> str:
    head = ("| arch | shape | mesh | compute | memory | collective | "
            "bottleneck | useful | comp-frac | bw-frac | roofline | "
            "peak/dev | fits 80 GB |\n"
            "|---|---|---|---|---|---|---|---|---|---|---|---|---|")
    out = [head]
    for r in rows:
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} "
            f"| {r['t_compute']*1e3:.2f} ms | {r['t_memory']*1e3:.2f} ms "
            f"| {r['t_collective']*1e3:.2f} ms | **{r['bottleneck']}** "
            f"| {r['useful_ratio']:.2f} | {r['comp_frac']:.3f} "
            f"| {r['bw_frac']:.3f} | **{r['roofline_frac']:.3f}** "
            f"| {r.get('peak_memory_bytes', 0.0)/1e9:.1f} GB "
            f"| {'yes' if r.get('fits', True) else '**no**'} |")
    return "\n".join(out)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--json", default="experiments/roofline.json")
    ap.add_argument("--out", default="experiments/roofline_table.md")
    args = ap.parse_args(argv)
    with open(args.json) as f:
        rows = [enrich(r) for r in json.load(f)]
    md = to_markdown(rows)
    with open(args.out, "w") as f:
        f.write(md + "\n")
    print(md)
    # the three hillclimb candidates
    worst = min(rows, key=lambda r: r["roofline_frac"])
    collbound = max(rows, key=lambda r: r["t_collective"]
                    / max(r["t_compute"], r["t_memory"], 1e-12))
    print(f"\nworst roofline: {worst['arch']}/{worst['shape']} "
          f"({worst['roofline_frac']:.3f})")
    print(f"most collective-bound: {collbound['arch']}/"
          f"{collbound['shape']}")
    print(f"over 80 GB a device: "
          f"{sum(not r['fits'] for r in rows)} of {len(rows)}")


if __name__ == "__main__":
    main()
