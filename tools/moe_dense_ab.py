#!/usr/bin/env python3
"""The MoE dense path's expert products two ways, on one card: as
``torch.einsum("td,edf->etf", ...)`` (which copies each ``[E, D, F]``
expert weight into a ``[D, E·F]`` layout on every call) and as the port's
``moe_dense`` (a batched product over the experts with the tokens
broadcast).

    python3 tools/moe_dense_ab.py

For dbrx-132b and deepseek-v2-236b at their published widths and bf16
parameters, cut to 2 layers (``chip_smoke.py`` phase 18's models and
seeds): a 1500-token prefill and the median of 16 decode steps after 4
warm-up steps (host clock around synchronised work), in turns einsum,
port, port, einsum; the largest gap between the two forms' logits over
the 20 steps; then 8 profiled decode steps of the port's form (wall and
device busy per step, its costliest kernels).  The last line is the
results as JSON after the word ``result``.  It needs a CUDA card.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
MODELS = (("dbrx-132b", 5), ("deepseek-v2-236b", 6))
PROMPT, STEPS, WARM = 1500, 20, 4


def einsum_dense(moe, cfg, p, x):
    """``moe_dense`` with the reference's einsums for the expert
    products."""
    import torch
    B, S, D = x.shape
    e = cfg.moe
    dt = x.dtype
    xf = x.reshape(B * S, D)
    gates, idx, aux = moe._router(cfg, p, xf)
    comb = torch.zeros((B * S, e.n_experts), dtype=dt, device=x.device)
    comb.scatter_add_(1, idx, gates)
    g = torch.einsum("td,edf->etf", xf, p["w_gate"].to(dt))
    h = torch.einsum("td,edf->etf", xf, p["w_in"].to(dt))
    hh = moe._act(cfg, g, h) * comb.T[:, :, None]
    y = torch.einsum("etf,efd->td", hh, p["w_out"].to(dt)).reshape(B, S, D)
    if e.n_shared > 0:
        y = y + moe._shared_mlp(cfg, p, x)
    return y, aux


def run(torch, model, params, toks):
    """(prefill ms, median decode ms, the decode steps' logits)."""
    cache = model.init_cache(1, 2048)
    model.prefill(params, toks[:, :64], model.init_cache(1, 2048))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = model.prefill(params, toks, cache)
    torch.cuda.synchronize()
    prefill = time.perf_counter() - t0
    tok = logits.argmax(-1)
    steps, seq = [], []
    for i in range(STEPS):
        pos = torch.full((1,), PROMPT + i, dtype=torch.int32, device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = model.decode_step(params, tok, cache, pos)
        torch.cuda.synchronize()
        steps.append(time.perf_counter() - t0)
        seq.append(logits.float())
        tok = logits.argmax(-1)
    kept = sorted(steps[WARM:])
    return prefill * 1e3, kept[len(kept) // 2] * 1e3, torch.cat(seq, 1)


def profile(torch, model, params, toks):
    from torch.profiler import ProfilerActivity, profile as prof_ctx
    cache = model.init_cache(1, 2048)
    logits, cache = model.prefill(params, toks[:, :777], cache)
    tok = logits.argmax(-1)
    with prof_ctx(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(8):
            logits, cache = model.decode_step(
                params, tok, cache,
                torch.full((1,), 777 + i, dtype=torch.int32, device="cuda"))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ks = [e for e in prof.key_averages()
          if e.device_type.name != "CPU" and e.self_device_time_total > 0]
    busy = sum(e.self_device_time_total for e in ks)
    top = sorted(ks, key=lambda e: -e.self_device_time_total)[:5]
    return wall / 8 * 1e3, busy / 8e3, [
        (e.key[:80], e.count, e.self_device_time_total / 8e3) for e in top]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("moe_dense_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import configs
    from repro_torch.models import moe
    from repro_torch.models.transformer import build_model
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    port_dense = moe.moe_dense
    forms = {"einsum": lambda cfg, p, x: einsum_dense(moe, cfg, p, x),
             "port": port_dense}
    out = {}
    try:
        for name, seed in MODELS:
            cfg = dataclasses.replace(configs.get(name), attn_impl="pallas",
                                      n_layers=2)
            model = build_model(cfg, "cuda")
            params = model.init(
                torch.Generator(device="cuda").manual_seed(seed))
            toks = torch.randint(0, cfg.vocab, (1, PROMPT), device="cuda",
                                 generator=torch.Generator(
                                     device="cuda").manual_seed(0))
            rows, logits = {}, {}
            for form in ("einsum", "port", "port", "einsum"):
                moe.moe_dense = forms[form]
                pre, dec, seq = run(torch, model, params, toks)
                logits.setdefault(form, seq)
                rows.setdefault(form, []).append(
                    dict(prefill_ms=pre, decode_ms=dec))
                print(f"{name} {form}: prefill of {PROMPT} {pre:.2f} ms, "
                      f"decode {dec:.3f} ms a step", flush=True)
            gap = float((logits["einsum"] - logits["port"]).abs().max())
            moe.moe_dense = port_dense
            wall, busy, top = profile(torch, model, params, toks)
            print(f"{name}: max |einsum - port| over the {STEPS} steps' "
                  f"logits {gap}; port: {wall:.3f} ms a step (profiler on), "
                  f"device busy {busy:.3f} ms")
            for key, count, ms in top:
                print(f"  {key}: {count} calls, {ms:.3f} ms a step")
            out[name] = dict(runs=rows, logit_gap=gap, wall_ms=wall,
                             busy_ms=busy)
            del model, params
            torch.cuda.empty_cache()
    finally:
        moe.moe_dense = port_dense
    print("result " + json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
