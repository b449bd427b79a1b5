#!/usr/bin/env python3
"""Where a training step's time goes, on one card: ``chip_smoke.py``
phase 19a's step (olmo-1b at published widths and all 16 layers, f32
parameters, bf16 compute, ``remat="full"``, lcg data at batch 8 × seq 64
in 2 microbatches, the launcher's AdamW).

    python3 tools/train_step_profile.py

After 2 warm-up steps: the median of 4 steps (host clock around a
synchronised step) and, in the same way, of its two parts (the
microbatched loss and gradients; ``adamw_update``); then 2 steps under
``torch.profiler``: device busy time a step, the idle share, kernel
launches a step and the costliest kernels.  The last line is the results
as JSON after the word ``result``.  It needs a CUDA card.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
BATCH, SEQ, MICRO, WARM, TIMED, PROFILED, TOP = 8, 64, 2, 2, 4, 2, 14


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("train_step_profile: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import configs
    from repro_torch.data.pipeline import make_data_iter
    from repro_torch.models.transformer import build_model
    from repro_torch.training.optimizer import OptCfg, adamw_update
    from repro_torch.training.train import (_accum_grads, build_train_step,
                                            init_train_state)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(card, flush=True)
    cfg = configs.get("olmo-1b")
    ocfg = OptCfg(lr=3e-4, warmup_steps=1, total_steps=6)
    model = build_model(cfg)
    state = init_train_state(model, torch.Generator("cuda").manual_seed(7))
    step = build_train_step(model, ocfg, microbatches=MICRO)
    data = make_data_iter("lcg", BATCH, SEQ, cfg.vocab)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    for i in range(WARM):
        state, _ = step(state, *data(i))
    rows = []
    for i in range(TIMED):
        tokens, labels = data(WARM + i)
        (loss, grads), grad_ms = timed(lambda: _accum_grads(
            model.loss, state.params, tokens, labels, MICRO))
        (new_p, new_opt, _), opt_ms = timed(lambda: adamw_update(
            ocfg, state.params, grads, state.opt))
        del grads
        state = state._replace(params=new_p, opt=new_opt)
        _, step_ms = timed(lambda: step(state, tokens, labels))
        rows.append(dict(step_ms=step_ms, grad_ms=grad_ms, adamw_ms=opt_ms))
    med = {k: statistics.median(r[k] for r in rows) for k in rows[0]}
    print(f"olmo-1b, 16 layers, {BATCH} x {SEQ} in {MICRO} microbatches: "
          f"step {med['step_ms']:.1f} ms (median of {TIMED}); loss and "
          f"gradients {med['grad_ms']:.1f} ms; adamw_update "
          f"{med['adamw_ms']:.1f} ms", flush=True)
    tokens, labels = data(WARM + TIMED)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(PROFILED):
            state, _ = step(state, tokens, labels)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / PROFILED
    kernels = [e for e in prof.key_averages()
               if e.device_type.name == "CUDA"
               and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / PROFILED
    launches = sum(e.count for e in kernels) / PROFILED
    top = sorted(kernels, key=lambda e: e.self_device_time_total,
                 reverse=True)[:TOP]
    print(f"profiled: wall {wall_ms:.1f} ms a step, device busy "
          f"{busy_ms:.1f} ms ({busy_ms / wall_ms:.3f}), idle share "
          f"{1 - busy_ms / wall_ms:.3f}, {launches:.0f} kernel launches a "
          f"step", flush=True)
    top_rows = []
    for e in top:
        ms = e.self_device_time_total / 1e3 / PROFILED
        print(f"  {e.key[:90]}: {e.count // PROFILED} calls, {ms:.2f} ms a "
              f"step", flush=True)
        top_rows.append(dict(kernel=e.key[:120], calls=e.count // PROFILED,
                             ms_per_step=ms))
    print("result " + json.dumps(dict(
        card=card, median=med, steps=rows, profiled_wall_ms=wall_ms,
        device_busy_ms=busy_ms, idle_share=1 - busy_ms / wall_ms,
        launches_per_step=launches, top=top_rows)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
