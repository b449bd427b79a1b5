"""§Perf hillclimb: hypothesis → change → re-trace → re-analyse
(counterpart of ``repro/roofline/hillclimb.py``).

Runs the three selected cells through their iteration ladders (each rung
toggles one optimization via cfg/rule overrides so the delta is
attributable), printing before/after roofline terms on the H100 model
(:mod:`repro_torch.roofline.analysis`) and writing
``experiments/perf_iterations.json``.  The hypotheses name mechanisms
only; the figures are the ones this run prints.

    PYTHONPATH=src python -m repro_torch.roofline.hillclimb
"""
from __future__ import annotations

import json
import os

# --- each entry: (arch, shape, label, hypothesis, kwargs) ---------------
RUNS = [
    # ---- Cell 1: granite-20b decode_32k (collective-bound serving) ----
    ("granite-20b", "decode_32k", "baseline",
     "MQA kv=1 → cache seq-sharded over model; without the flash-decode "
     "merge the [B,H,S] scores are gathered across the model axis every "
     "layer: a large collective term and extra HBM traffic.",
     dict(cfg_overrides={"flash_decode": False})),
    ("granite-20b", "decode_32k", "+flash-decode",
     "partial-softmax merge: scores stay local [B,H,S/16] f32; the "
     "combine is a MAX of m and a SUM of (l, o) per layer → the "
     "collective term and the memory term down.",
     dict()),
    # ---- Cell 2: deepseek-v2-236b decode_32k (worst cell) -------------
    ("deepseek-v2-236b", "decode_32k", "baseline",
     "Two pathologies: (a) the FSDP weight layout forces a per-layer "
     "expert weight all-gather, far more than the 128 tokens need; "
     "(b) MLA scores materialize gathered f32 [B,H,S] arrays.",
     dict(cfg_overrides={"flash_decode": False},
          rule_overrides={"fsdp": "data", "expert_ff": None})),
    ("deepseek-v2-236b", "decode_32k", "+mla-flash-decode",
     "latent-space partial softmax over the seq-sharded c_kv cache "
     "(scores local, a sum of [B,H,kv_lora]) → memory term down.",
     dict(rule_overrides={"fsdp": "data", "expert_ff": None})),
    ("deepseek-v2-236b", "decode_32k", "+serving-weight-layout",
     "the decode latency path must not FSDP-gather: shard the experts' "
     "ff dim over 'data' instead (reads local, the combine sum is "
     "[T,D]-sized) → collective term down.",
     dict()),
    # ---- Cell 3: qwen3-14b train_4k (collective-bound training) -------
    ("qwen3-14b", "train_4k", "baseline",
     "40 heads on 16-way TP: the heads do not split, so the head-sharded "
     "tensors are replicated around every attention block.",
     dict(cfg_overrides={"gqa_pad": False})),
    ("qwen3-14b", "train_4k", "+gqa-pad",
     "pad q heads 40→48 inside each KV group + replicate kv 8→16: all "
     "head dims divide TP → the copies vanish; cost ≤1.2x attention "
     "FLOPs.",
     dict()),
    ("qwen3-14b", "train_4k", "+remat-dots",
     "full remat recomputes every matmul in backward; checkpoint_dots "
     "keeps matmul outputs → FLOPs ≈ model FLOPs.",
     dict(cfg_overrides={"remat": "dots"})),
]


def run(runs=RUNS, out="experiments/perf_iterations.json") -> list:
    """Every rung of ``runs``: its enriched roofline row with its label
    and hypothesis, printed beside the rung before it."""
    from repro_torch.roofline.analysis import fmt_row, roofline_cell
    from repro_torch.roofline.report import enrich
    rows = []
    prev_key = None
    prev = None
    for arch, shape, label, hyp, kw in runs:
        r = roofline_cell(arch, shape, **kw)
        e = enrich(r.row())
        key = (arch, shape)
        print(f"\n=== {arch} / {shape} — {label} ===", flush=True)
        print(f"hypothesis: {hyp}")
        print(fmt_row(r))
        print(f"  comp-frac={e['comp_frac']:.4f} bw-frac={e['bw_frac']:.4f}"
              f" roofline={e['roofline_frac']:.4f}")
        if prev is not None and prev_key == key:
            for t in ("t_compute", "t_memory", "t_collective"):
                b, a = prev[t], e[t]
                print(f"  {t}: {b*1e3:10.2f} → {a*1e3:10.2f} ms  "
                      f"({b/max(a,1e-12):5.1f}x)")
        e.update(label=label, hypothesis=hyp)
        rows.append(e)
        prev, prev_key = e, key
    if out:
        os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
        with open(out, "w") as f:
            json.dump(rows, f, indent=1)
        print(f"\nwrote {out}")
    return rows


def main() -> None:
    run()


if __name__ == "__main__":
    main()
