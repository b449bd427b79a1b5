"""One rank of a ``gloo`` process group on the CPU, for
``tests/test_torch_distributed.py``.

    python tests/torch_dist_worker.py SCENARIO RANK WORLD PORT IN.npz OUT_DIR

Imports torch and ``repro_torch`` only.  ``IN.npz`` holds what the test
made with numpy and the reference (weights as ``p/<leaf path>``, tokens,
activations); each rank writes ``OUT_DIR/rank<r>.npz`` with what the
test holds to the reference (full tensors).  The group's rendezvous and
every collective time out after ``TIMEOUT_S``.
"""
import dataclasses
import datetime
import os
import socket
import subprocess
import sys

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import configs
from repro_torch.distribution import sharding as sh
from repro_torch.kernels.mamba2_ssd import ops as ssd_ops
from repro_torch.kernels.rwkv6_wkv import ops as wkv_ops
from repro_torch.launch.mesh import make_ctx, make_test_mesh
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models.common import MoECfg
from repro_torch.models.transformer import build_model
from repro_torch.training.checkpoint import CheckpointManager
from repro_torch.training.optimizer import OptCfg
from repro_torch.training.train import (_inner, build_train_step,
                                        build_train_step_compressed,
                                        init_train_state, shard_train_state,
                                        value_and_grad)
from repro_torch.training.tree import (flatten_with_paths, tree_leaves,
                                       unflatten_like)

TIMEOUT_S = 90
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class Ranks:
    """Scenario ``name`` running on ``world`` ranks (one process each)
    from the arrays ``inp``, started at once so that the caller's own
    reference run overlaps them; :meth:`wait` returns each rank's output
    arrays.  A rank that fails or outlives ``timeout`` fails the caller
    with its error output."""

    def __init__(self, name: str, world: int, inp: dict, tmp_path,
                 timeout: float = 150):
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        inp_path = os.path.join(tmp_path, "in.npz")
        np.savez(inp_path, **inp)
        env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
                   OMP_NUM_THREADS="1")
        self.name, self.world, self.dir = name, world, str(tmp_path)
        self.timeout = timeout
        self.procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), name, str(r),
             str(world), str(port), inp_path, self.dir], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for r in range(world)]

    def wait(self) -> list:
        try:
            errs = [p.communicate(timeout=self.timeout)[1]
                    for p in self.procs]
        finally:
            for p in self.procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        for r, (p, e) in enumerate(zip(self.procs, errs)):
            assert p.returncode == 0, f"rank {r} of {self.name}: {e[-4000:]}"
        out = []
        for r in range(self.world):
            with np.load(os.path.join(self.dir, f"rank{r}.npz")) as f:
                out.append(dict(f))
        return out


def f32(name):
    return dataclasses.replace(configs.get_smoke(name), dtype="float32")


def load_params(like, data, prefix="p/"):
    """``like``'s structure with the leaves of ``data`` at its paths."""
    return unflatten_like(like, [
        torch.from_numpy(data[prefix + "/".join(path)]).to(leaf.dtype)
        for path, leaf in flatten_with_paths(like)])


def save_tree(out, prefix, tree):
    for path, leaf in flatten_with_paths(tree):
        out[prefix + "/".join(path)] = sh.full(leaf).detach().float().numpy()


def _ctx(shape, axes, **rule_overrides):
    mesh = make_test_mesh(shape, axes, device_type="cpu")
    multi = "pod" in axes
    rules = sh.make_rules(multi_pod=multi)
    rules.update(rule_overrides)
    return sh.ShardCtx(mesh=mesh, rules=rules,
                       dp_axes=("pod", "data") if multi else ("data",),
                       pod_axis="pod" if multi else None)


def train(data, out, arch=None, key=""):
    """The inputs' ``steps`` (else 3) AdamW steps of a smoke config (f32;
    ``arch``, else the inputs' ``arch``, else olmo-1b; with ``fsdp`` on
    where the inputs ask; at their ``lr``, else 1e-2) on a (2, 2) mesh
    under ``make_ctx``, from the test's weights (``p/``, or ``p.<arch>/``
    for a named ``arch``); rank 0 also runs the one-device steps.  The
    outputs' names start with ``key``."""
    prefix = "p/" if arch is None else f"p.{arch}/"
    arch = arch or (str(data["arch"]) if "arch" in data else "olmo-1b")
    cfg = dataclasses.replace(f32(arch),
                              fsdp=bool(data.get("fsdp", False)))
    ocfg = OptCfg(lr=float(data.get("lr", 1e-2)), warmup_steps=2,
                  total_steps=10)
    n_steps = int(data.get("steps", 3))
    tokens = torch.from_numpy(data["tokens"])
    labels = torch.from_numpy(data["labels"])
    model = build_model(cfg, "cpu")
    params = load_params(model.init(torch.Generator().manual_seed(0)), data,
                         prefix)
    ctx = make_ctx(make_test_mesh((2, 2), ("data", "model"),
                                  device_type="cpu"), cfg)
    out[key + "fsdp"] = np.array(str(ctx.rules["fsdp"]))
    with sh.sharding_ctx(ctx):
        state = init_train_state(model, torch.Generator().manual_seed(0))
        state = shard_train_state(state._replace(params=params), model, ctx)
        placed = sorted({str(leaf.placements) for leaf in
                         tree_leaves(state.params)})
        step = build_train_step(model, ocfg)
        for i in range(n_steps):
            state, m = step(state, tokens, labels)
            out[f"{key}loss{i}"] = np.float32(m["loss"])
    out[key + "placements"] = np.array(placed)
    save_tree(out, key + "sharded/", state.params)
    if dist.get_rank() == 0:
        s = init_train_state(model, torch.Generator().manual_seed(0))
        s = s._replace(params=params)
        step = build_train_step(model, ocfg)
        for i in range(n_steps):
            s, m = step(s, tokens, labels)
            out[f"{key}single_loss{i}"] = np.float32(m["loss"])
        save_tree(out, key + "single/", s.params)


def moe(data, out):
    """``moe_ep`` on a (2, 2) mesh under ``make_ctx`` against
    ``moe_dense``, dbrx-132b's smoke config with 4 experts, top 2,
    capacity factor 16 (and ``fsdp`` on where the inputs ask: the expert
    weights' ``d_model`` dim over ``data``, gathered before use; the
    gathers counted), the weights laid out by the model's specs."""
    cfg = dataclasses.replace(
        configs.get_smoke("dbrx-132b"), fsdp=bool(data.get("fsdp", False)),
        moe=MoECfg(n_experts=4, top_k=2, d_ff_expert=64,
                   capacity_factor=16.0))
    like = moe_mod.init_moe(torch.Generator().manual_seed(0), cfg)
    p = load_params(like, data)
    x = torch.from_numpy(data["x"])
    ctx = make_ctx(make_test_mesh((2, 2), ("data", "model"),
                                  device_type="cpu"), cfg)
    gathers = []
    gather0 = moe_mod._gather

    def gather(w, axis, dim):
        gathers.append(axis)
        return gather0(w, axis, dim)

    moe_mod._gather = gather
    with sh.sharding_ctx(ctx):
        specs = build_model(cfg, "meta").param_specs()["layers"][0]["mlp"]
        pd = sh.param_sharding_tree(p, specs, ctx.mesh)
        out["w_in_placements"] = np.array(str(pd["w_in"].placements))
        with sh.plain_as_replicated():
            y, aux = moe_mod.moe_ep(cfg, pd, x)
    out["gathers"] = np.array(gathers)
    out["y"] = sh.full(y).float().numpy()
    out["aux"] = np.float32(sh.full(aux))
    y_d, aux_d = moe_mod.moe_dense(cfg, p, x)
    out["y_dense"] = y_d.float().numpy()
    out["aux_dense"] = np.float32(aux_d)


def compressed(data, out):
    """5 steps of the compressed cross-pod step on a (2, 2, 2) mesh beside
    the exact step on the same mesh; the first compressed step's pieces
    (each pod's gradients, the synced ones, the update) for the test's
    exactness check."""
    cfg = f32("olmo-1b")
    ocfg = OptCfg(lr=5e-3, warmup_steps=2, total_steps=20)
    tokens = torch.from_numpy(data["tokens"])
    labels = torch.from_numpy(data["labels"])
    model = build_model(cfg, "cpu")
    params = load_params(model.init(torch.Generator().manual_seed(0)), data)
    ctx = _ctx((2, 2, 2), ("pod", "data", "model"))
    with sh.sharding_ctx(ctx):
        base = init_train_state(model, torch.Generator().manual_seed(0),
                                compressed=True)._replace(params=params)
        sc = shard_train_state(base, model, ctx)
        se = shard_train_state(base._replace(err=None), model, ctx)
        step_c = build_train_step_compressed(model, ocfg)
        step_e = build_train_step(model, ocfg)
        # the first step's gradients of this rank's pod, as the step
        # computes them (its inner context on the pod's submesh)
        b = tokens.shape[0] // 2
        pod = ctx.mesh.get_local_rank("pod")
        with sh.sharding_ctx(_inner(ctx)), sh.plain_as_replicated():
            _, g = value_and_grad(model.loss, sc.params,
                                  tokens[pod * b:(pod + 1) * b],
                                  labels[pod * b:(pod + 1) * b])
        save_tree(out, "pod_grads/", g)
        out["pod"] = np.int64(pod)
        for i in range(5):
            sc, mc = step_c(sc, tokens, labels)
            se, me = step_e(se, tokens, labels)
            out[f"loss_c{i}"] = np.float32(mc["loss"])
            out[f"loss_e{i}"] = np.float32(me["loss"])
            if i == 0:
                save_tree(out, "step1/", sc.params)
                save_tree(out, "err1/", sc.err)
    out["placements"] = np.array(sorted({
        f"{leaf.device_mesh.mesh_dim_names}{leaf.placements}"
        for leaf in tree_leaves(sc.params)}))


def remesh(data, out):
    """Save gemma-2b's smoke parameters laid out on a (2, 4) mesh, restore
    them onto (4, 2)."""
    cfg = configs.get_smoke("gemma-2b")
    model = build_model(cfg, "cpu")
    params = load_params(model.init(torch.Generator().manual_seed(0)), data)
    ctx_a = _ctx((2, 4), ("data", "model"))
    with sh.sharding_ctx(ctx_a):
        pa = sh.param_sharding_tree(params, model.param_specs(), ctx_a.mesh)
    d = data["dir"].item()
    mgr = CheckpointManager(d)
    mgr.save(pa, 1, blocking=True)
    ctx_b = _ctx((4, 2), ("data", "model"))
    with sh.sharding_ctx(ctx_b):
        tree_b = sh.sharding_tree(model.param_specs(), ctx_b.mesh)
    restored, step = mgr.restore(pa, sharding_tree=tree_b)
    out["step"] = np.int64(step)
    same, data4 = [], []
    for (path, a), b in zip(flatten_with_paths(params),
                            tree_leaves(restored)):
        same.append(bool(torch.equal(a, b.full_tensor())))
        names = b.device_mesh.mesh_dim_names
        data4.append(b.device_mesh.size(names.index("data")) == 4
                     and b.placements == tree_leaves(tree_b)[len(same) - 1]
                     .placements)
    out["same"] = np.array(same)
    out["on_new_mesh"] = np.array(data4)
    save_tree(out, "restored/", restored)


def seqdecode(data, out):
    """qwen3-14b's smoke config (f32; kv heads 2 ∤ model 4): one decode
    step over a seq-sharded cache on a (2, 4) mesh, from the test's
    weights and the unsharded prefill's cache."""
    cfg = f32("qwen3-14b")
    model = build_model(cfg, "cpu")
    params = load_params(model.init(torch.Generator().manual_seed(0)), data)
    toks = torch.from_numpy(data["toks"])
    B, S = toks.shape
    cache = model.init_cache(B, S + 4)
    model.prefill(params, toks, cache)
    pos = torch.full((B,), S, dtype=torch.int32)
    ctx = _ctx((2, 4), ("data", "model"))
    with sh.sharding_ctx(ctx):
        cspec = model.cache_specs(B, S + 4)
        out["cache_spec"] = np.array(repr(cspec["k"]))
        cs = sh.param_sharding_tree(cache, cspec, ctx.mesh)
        logits, cs = model.decode_step(params, toks[:, :1], cs, pos)
    out["logits"] = sh.full(logits).float().numpy()
    save_tree(out, "cache/", cs)


def gqapad(data, out):
    """H 6, KV 2 on a (1, 4) mesh: the padded heads, ``sdpa`` on them and
    a whole forward against the unsharded ones."""
    cfg = dataclasses.replace(f32("olmo-1b"), n_heads=6, n_kv_heads=2,
                              attn_impl="naive")
    q, k, v = (torch.from_numpy(data[n]) for n in ("q", "k", "v"))
    ctx = _ctx((1, 4), ("data", "model"))
    model = build_model(cfg, "cpu")
    params = load_params(model.init(torch.Generator().manual_seed(0)), data)
    tokens = torch.from_numpy(data["tokens"])
    with sh.sharding_ctx(ctx):
        with sh.plain_as_replicated():
            qs = sh.shard(q, "batch", "seq", "heads", None)
            ks = sh.shard(k, "batch", "seq", "kv_heads", None)
            vs = sh.shard(v, "batch", "seq", "kv_heads", None)
            qp, kp, vp, _ = attn._gqa_tp_pad(cfg, qs, ks, vs)
            o = attn.sdpa(cfg, qs, ks, vs)
        pd = sh.param_sharding_tree(params, model.param_specs(), ctx.mesh)
        logits, _ = model.forward(pd, tokens)
    out["padded_shape"] = np.array([tuple(t.shape) for t in (qp, kp, vp)])
    out["qp_placements"] = np.array(str(qp.placements))
    out["o"] = sh.full(o).numpy()
    out["o_ref"] = attn.sdpa(cfg, q, k, v).numpy()
    out["logits"] = sh.full(logits).numpy()
    out["logits_ref"] = model.forward(params, tokens)[0].numpy()


def serve(data, out):
    """Prefill and two decode steps of olmo-1b's smoke config under
    ``pallas`` (the attention kernels' plain versions here) on a (2, 2)
    mesh, parameters and cache laid out by their specs."""
    cfg = dataclasses.replace(f32("olmo-1b"), attn_impl="pallas")
    model = build_model(cfg, "cpu")
    params = load_params(model.init(torch.Generator().manual_seed(0)), data)
    toks = torch.from_numpy(data["toks"])
    B, S = toks.shape
    ctx = _ctx((2, 2), ("data", "model"))
    with sh.sharding_ctx(ctx):
        pd = sh.param_sharding_tree(params, model.param_specs(), ctx.mesh)
        cache = sh.param_sharding_tree(model.init_cache(B, S + 2),
                                       model.cache_specs(B, S + 2),
                                       ctx.mesh)
        lg, cache = model.prefill(pd, toks, cache)
        outs = [sh.full(lg)]
        for i in range(2):
            pos = torch.full((B,), S + i, dtype=torch.int32)
            lg, cache = model.decode_step(pd, toks[:, i:i + 1], cache, pos)
            outs.append(sh.full(lg))
    out["logits"] = torch.cat(outs, dim=1).numpy()
    save_tree(out, "cache/", cache)


def mla(data, out):
    """deepseek-v2-236b's smoke config (MLA, MoE with shared experts;
    f32): prefill through ``moe_ep`` and two decode steps over the latent
    cache seq-sharded over ``model``, on a (2, 2) mesh, parameters and
    cache laid out by their specs."""
    cfg = f32("deepseek-v2-236b")
    model = build_model(cfg, "cpu")
    params = load_params(model.init(torch.Generator().manual_seed(0)), data)
    toks = torch.from_numpy(data["toks"])
    B, S = toks.shape
    ctx = _ctx((2, 2), ("data", "model"))
    with sh.sharding_ctx(ctx):
        pd = sh.param_sharding_tree(params, model.param_specs(), ctx.mesh)
        cspec = model.cache_specs(B, S + 2)
        out["cache_spec"] = np.array(repr(cspec["c_kv"]))
        cache = sh.param_sharding_tree(model.init_cache(B, S + 2), cspec,
                                       ctx.mesh)
        lg, cache = model.prefill(pd, toks, cache)
        outs = [sh.full(lg)]
        for i in range(2):
            pos = torch.full((B,), S + i, dtype=torch.int32)
            lg, cache = model.decode_step(pd, toks[:, i:i + 1], cache, pos)
            outs.append(sh.full(lg))
    out["logits"] = torch.cat(outs, dim=1).float().numpy()
    save_tree(out, "cache/", cache)


def recurrent(data, out):
    """For each of ``meshes`` (``data × model`` shapes over this world)
    and its ``archs`` (comma-separated), the smoke configs in ``dtypes``
    (``attn_impl="pallas"``, the kernels' plain versions here), parameters
    and caches laid out by their specs: the full forward over ``toks``,
    then a prefill of its first ``S`` tokens and a teacher-forced decode
    step for each of the rest; the logits and the final cache, full on
    every rank, and the heads each scan was given, under ``<mesh>/``."""
    toks = torch.from_numpy(data["toks"])
    B, n = toks.shape
    S = int(data["S"])
    seen = {}

    def record(mod, name):
        """The scan entry point ``mod.name`` noting the heads it was given
        and whether any input was a DTensor."""
        fn = getattr(mod, name)

        def scan(*args, **kw):
            seen.setdefault(name, set()).add(
                (args[0].shape[2], any(sh.is_dtensor(a) for a in args)))
            return fn(*args, **kw)
        setattr(mod, name, scan)

    record(wkv_ops, "wkv6")
    record(ssd_ops, "ssd")
    for shape, archs in zip(data["meshes"], data["mesh_archs"]):
        shape = tuple(int(a) for a in shape)
        mesh = make_test_mesh(shape, ("data", "model"), device_type="cpu")
        tag = "x".join(map(str, shape)) + "/"
        seen.clear()
        for arch in str(archs).split(","):
            for dtype in data["dtypes"]:
                cfg = dataclasses.replace(configs.get_smoke(arch),
                                          dtype=dtype, attn_impl="pallas")
                model = build_model(cfg, "cpu")
                params = load_params(
                    model.init(torch.Generator().manual_seed(0)), data,
                    f"p.{arch}/")
                key = f"{tag}{arch}/{dtype}/"
                with sh.sharding_ctx(make_ctx(mesh, cfg)):
                    pd = sh.param_sharding_tree(params, model.param_specs(),
                                                mesh)
                    cspec = model.cache_specs(B, n)
                    cache = sh.param_sharding_tree(model.init_cache(B, n),
                                                   cspec, mesh)
                    out[key + "forward"] = sh.full(
                        model.forward(pd, toks)[0]).float().numpy()
                    lg, cache = model.prefill(pd, toks[:, :S], cache)
                    served = [sh.full(lg)]
                    for i in range(S, n):
                        lg, cache = model.decode_step(
                            pd, toks[:, i:i + 1], cache,
                            torch.full((B,), i, dtype=torch.int32))
                        served.append(sh.full(lg))
                out[key + "served"] = torch.cat(served, dim=1).float().numpy()
                out[key + "cache_specs"] = np.array(
                    [f"{k}: {v!r}" for k, v in sorted(cspec.items())])
                save_tree(out, key + "cache/", cache)
        for name, calls in seen.items():
            out[f"{tag}scan/{name}"] = np.array(sorted(calls))


def recurrent_train(data, out):
    """For each of ``archs`` (comma-separated; smoke configs, f32): the
    loss and gradients of one sharded ``value_and_grad`` on a (2, 2) mesh
    under ``make_ctx``, parameters laid out by their specs (under
    ``grad.<arch>/``, full on every rank), then :func:`train`'s AdamW
    steps (under ``train.<arch>/``)."""
    tokens = torch.from_numpy(data["tokens"])
    labels = torch.from_numpy(data["labels"])
    mesh = make_test_mesh((2, 2), ("data", "model"), device_type="cpu")
    for arch in str(data["archs"]).split(","):
        cfg = f32(arch)
        model = build_model(cfg, "cpu")
        params = load_params(model.init(torch.Generator().manual_seed(0)),
                             data, f"p.{arch}/")
        with sh.sharding_ctx(make_ctx(mesh, cfg)):
            pd = sh.param_sharding_tree(params, model.param_specs(), mesh)
            with sh.plain_as_replicated():
                loss, g = value_and_grad(model.loss, pd, tokens, labels)
            out[f"grad.{arch}/loss"] = np.float32(sh.full(loss))
            save_tree(out, f"grad.{arch}/g/", g)
        train(data, out, arch, f"train.{arch}/")


def decode_rules(data, out):
    """dbrx-132b's smoke config (f32, ``fsdp`` on): a prefill on one
    device, then two decode steps on a (2, 2) mesh under ``make_ctx`` with
    a decode ``shape_cfg`` (FSDP off, the expert weights' ff dim over
    ``data``), parameters and cache laid out by their specs."""
    cfg = dataclasses.replace(f32("dbrx-132b"), fsdp=True)
    model = build_model(cfg, "cpu")
    params = load_params(model.init(torch.Generator().manual_seed(0)), data)
    toks = torch.from_numpy(data["toks"])
    B, S = toks.shape
    cache = model.init_cache(B, S + 2)
    model.prefill(params, toks, cache)
    mesh = make_test_mesh((2, 2), ("data", "model"), device_type="cpu")
    ctx = make_ctx(mesh, cfg, configs.smoke_shape(configs.SHAPES[
        "decode_32k"]))
    out["rules"] = np.array([f"{k}={ctx.rules[k]}" for k in
                             ("fsdp", "expert_ff", "act_seq", "seq_kv")])
    with sh.sharding_ctx(ctx):
        pd = sh.param_sharding_tree(params, model.param_specs(), mesh)
        out["w_in_placements"] = np.array(str(
            pd["layers"][0]["mlp"]["w_in"].placements))
        cs = sh.param_sharding_tree(cache, model.cache_specs(B, S + 2), mesh)
        outs = []
        for i in range(2):
            pos = torch.full((B,), S + i, dtype=torch.int32)
            lg, cs = model.decode_step(pd, toks[:, i:i + 1], cs, pos)
            outs.append(sh.full(lg))
    out["logits"] = torch.cat(outs, dim=1).numpy()
    save_tree(out, "cache/", cs)


def moe_train(data, out):
    """For each of ``cases`` (``<arch>/<D>x<M>/<fsdp0|fsdp1>/<batch key>``;
    smoke configs): on a ``D × M`` ``data × model`` mesh under
    ``make_ctx`` (``fsdp`` as the case says), parameters laid out by their
    specs from the test's weights (``p.<arch>/``) and the batch
    ``tokens.<key>``, ``labels.<key>``: one sharded ``value_and_grad``
    (under ``<case>/grad/``, full on every rank), then ``steps`` AdamW
    steps at ``lr`` (the losses and the parameters under
    ``<case>/``).  The parameters are f32 too."""
    ocfg = OptCfg(lr=float(data["lr"]), warmup_steps=2, total_steps=10)
    for case in (str(c) for c in data["cases"]):
        arch, shape, fsdp, key = case.split("/")
        cfg = dataclasses.replace(f32(arch), param_dtype="float32",
                                  fsdp=fsdp == "fsdp1")
        tokens = torch.from_numpy(data["tokens." + key])
        labels = torch.from_numpy(data["labels." + key])
        model = build_model(cfg, "cpu")
        params = load_params(model.init(torch.Generator().manual_seed(0)),
                             data, f"p.{arch}/")
        mesh = make_test_mesh(tuple(int(a) for a in shape.split("x")),
                              ("data", "model"), device_type="cpu")
        ctx = make_ctx(mesh, cfg)
        with sh.sharding_ctx(ctx):
            pd = sh.param_sharding_tree(params, model.param_specs(), mesh)
            with sh.plain_as_replicated():
                loss, g = value_and_grad(model.loss, pd, tokens, labels)
            out[f"{case}/grad/loss"] = np.float32(sh.full(loss))
            save_tree(out, f"{case}/grad/g/", g)
            state = init_train_state(model, torch.Generator().manual_seed(0))
            state = shard_train_state(state._replace(params=params), model,
                                      ctx)
            out[f"{case}/placements"] = np.array(sorted({
                str(leaf.placements) for leaf in tree_leaves(state.params)}))
            step = build_train_step(model, ocfg)
            for i in range(int(data["steps"])):
                state, m = step(state, tokens, labels)
                out[f"{case}/loss{i}"] = np.float32(m["loss"])
        save_tree(out, f"{case}/params/", state.params)


SCENARIOS = {f.__name__: f for f in (train, moe, compressed, remesh,
                                     seqdecode, gqapad, serve, mla,
                                     recurrent, recurrent_train,
                                     decode_rules, moe_train)}


def main(argv):
    name, rank, world, port, inp, out_dir = argv
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{port}", rank=int(rank),
        world_size=int(world), timeout=datetime.timedelta(seconds=TIMEOUT_S))
    try:
        with np.load(inp, allow_pickle=False) as f:
            data = dict(f)
        out = {}
        SCENARIOS[name](data, out)
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
