"""The dry-run census: every (arch × shape × mesh) cell's step traced on a
fake world (counterpart of ``repro/launch/dryrun.py``).

The reference compiles each cell's step for 512 placeholder XLA devices
and reads memory, FLOPs and collectives off the compiled module.  The
port traces the same step instead, with nothing allocated anywhere:

* a fake process group of 256 ranks (the 16 × 16 ``data × model`` mesh)
  or 512 (2 × 16 × 16 with ``pod``), started here, in this process, as
  rank 0 (torch's ``fake`` backend: collectives return at once);
* the port's own ``make_production_mesh(device_type="cpu")`` and
  ``make_ctx`` over it, and parameters, caches and inputs on the ``meta``
  device from :mod:`repro_torch.launch.specs`, laid out by their specs;
* the step the shape lowers: the train step (forward, backward, AdamW),
  ``prefill`` or ``decode_step``, with attention as ``xla_unrolled``
  (blocks of ``S / 8``: the causal FLOPs, as the reference's roofline
  counts them, in few ops).

It is the one entry point of the port that takes no ``device``: it runs
on no device at all, and needs no card.  Without torch's fake process
group it raises :class:`FakeWorldMissingError`; it does not fall back to
a real one.

Per cell, for rank 0, a :class:`CellResult` with the reference's fields:

* ``flops``: a dispatch mode sees a DTensor op whole (its global
  shapes), never the rank's local op, so each op's global FLOPs
  (``torch.utils.flop_counter``'s formulas: the products) are divided by
  the product of the mesh sizes over which its output is ``Shard`` or
  ``Partial``; a replicated op counts whole on every rank; an op on plain
  tensors (a manual region's local work) counts as it is;
* ``bytes_accessed``: each op's input and output bytes as the rank holds
  them (a DTensor's local tensor: its shard, or the whole shape where it
  is ``Replicate`` or ``Partial``), views and detaches free;
* ``arg_bytes``: the local bytes of the step's arguments (parameters,
  AdamW's moments, the cache, the inputs) by their specs' placements, at
  full depth; ``param_bytes`` the parameters' share of it;
* ``temp_bytes``: the peak of the local bytes the step allocates and
  holds (every storage an op makes, on the rank, while it lives: the
  gradients, the new state, activations, a redistribution's buffers);
  ``peak_memory_bytes`` = ``arg_bytes + temp_bytes``;
* ``collectives``: the result bytes of every collective by kind
  (``all-gather``, ``all-reduce``, ``reduce-scatter``, ``all-to-all``),
  DTensor's and the manual regions' c10d calls alike, their ``total``,
  and ``cross_node`` and ``cross_pod``: the bytes of those whose group
  spans more than one node of 8 ranks, or more than one pod of 256 (the
  reference's ``pod_stride``).

**Depth.**  A trace costs host time in proportion to the layers it runs,
so the traced terms come from two traces, at ``unit`` and ``2 · unit``
layers (``repro_torch.roofline.analysis._unit``), and the reference's
affine fit ``cost(L) = fixed + per_layer · L`` takes them to the full
depth (layers are homogeneous, so the fit is exact); ``n_layers=`` traces
that depth directly instead.  ``arg_bytes`` is read at full depth.

Usage::

    python -m repro_torch.launch.dryrun --all [--mesh both] [--jobs 6] \
        [--out experiments/dryrun.json]
    python -m repro_torch.launch.dryrun --arch qwen3-14b --shape train_4k
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import logging
import os
import time
import weakref

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

#: ranks of one node, and of one pod, for the cross-node and cross-pod
#: tallies
NODE_RANKS = 8
POD_RANKS = 256
KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all")


class FakeWorldMissingError(RuntimeError):
    """torch's fake process group, which the census runs on, is missing."""


class WorldTakenError(RuntimeError):
    """A process group that is not the census's fake world is running."""


def start_world(n: int) -> None:
    """This process as rank 0 of a fake world of ``n`` ranks (the census's
    own; a fake world of another size is replaced)."""
    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:
        raise FakeWorldMissingError(
            "the census needs torch's fake process group "
            "(torch.testing._internal.distributed.fake_pg)") from e
    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise WorldTakenError(
                f"a {dist.get_backend()!r} process group is running; the "
                f"census starts its own fake world")
        if dist.get_world_size() == n:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)


@dataclasses.dataclass
class CellResult:
    arch: str
    shape: str
    mesh: str
    status: str               # ok | skip | fail
    reason: str = ""
    seconds: float = 0.0
    flops: float = 0.0                # per device
    bytes_accessed: float = 0.0       # per device
    peak_memory_bytes: float = 0.0    # per device
    arg_bytes: float = 0.0
    temp_bytes: float = 0.0
    collectives: dict = dataclasses.field(default_factory=dict)
    param_bytes: float = 0.0
    n_layers: int = 0                 # the depth the terms stand for

    def row(self):
        return dataclasses.asdict(self)


# -- the trace ---------------------------------------------------------------

def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _tensors(tree, out=None) -> list:
    """The tensors in ``tree`` (an op's arguments or results: tensors in
    lists, tuples and dicts)."""
    out = [] if out is None else out
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, (list, tuple)):
        for t in tree:
            _tensors(t, out)
    elif isinstance(tree, dict):
        for t in tree.values():
            _tensors(t, out)
    return out


def _divisor(t) -> int:
    """The product of the mesh sizes over which DTensor ``t`` is ``Shard``
    or ``Partial`` (1 for a plain tensor)."""
    from repro_torch.distribution.sharding import is_dtensor
    if not is_dtensor(t):
        return 1
    n = 1
    for i, p in enumerate(t.placements):
        if p.is_shard() or p.is_partial():
            n *= t.device_mesh.size(i)
    return n


#: ops that move no bytes of their own
_FREE = {"detach", "alias", "lift_fresh", "_unsafe_view"}


class _PerDevice(TorchDispatchMode):
    """FLOPs and bytes of every op on the rank (the outer mode: it sees a
    DTensor op whole, and a plain op as it is): the FLOPs by the divisor
    rule, the bytes of the op's inputs and outputs as the rank holds them;
    each output held by ``local``."""

    def __init__(self, local):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self.registry = flop_registry
        self.local = local
        self.flops = 0.0
        self.bytes = 0.0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if isinstance(func, torch._ops.HigherOrderOperator):
            return out
        outs = _tensors(out)
        pkt = func._overloadpacket
        f = self.registry.get(pkt)
        if f is not None:
            div = _divisor(outs[0]) if outs else 1
            self.flops += f(*args, **kwargs, out_val=out) / div
        if not func.is_view and pkt.__name__ not in _FREE:
            ins = [_local(t) for t in _tensors((args, kwargs))]
            outs = [_local(t) for t in outs]
            self.bytes += sum(_nbytes(t) for t in ins + outs)
            for t in outs:
                self.local.hold(t)
        return out


def _local(t):
    """The rank's own tensor of ``t`` (a DTensor's local shard; a
    ``Partial`` one is whole-sized on every rank)."""
    return getattr(t, "_local_tensor", t)


def _kind(name: str) -> str | None:
    n = name.replace("_", "")
    for kind, keys in (("all-gather", ("allgather",)),
                       ("reduce-scatter", ("reducescatter",)),
                       ("all-to-all", ("alltoall",)),
                       ("all-reduce", ("allreduce",))):
        if any(k in n for k in keys):
            return kind
    return None


def _group_ranks(args) -> list:
    """The global ranks of the process group a collective's arguments
    name (a group object, or a functional collective's group name)."""
    from torch.distributed.distributed_c10d import _resolve_process_group
    for a in args:
        if isinstance(a, dist.ProcessGroup):
            return dist.get_process_group_ranks(a)
        if isinstance(a, str):
            try:
                return dist.get_process_group_ranks(
                    _resolve_process_group(a))
            except (ValueError, RuntimeError, KeyError):
                continue
    return list(range(dist.get_world_size()))


class _Local(TorchDispatchMode):
    """What the rank holds and sends (the inner mode: a DTensor op is let
    through to DTensor, whose local ops, its collectives among them, come
    back here as plain ones): the result bytes of every collective, and
    the live bytes of every storage held by :meth:`hold` (an op's output,
    a collective's result; not DTensor's own global-shaped stand-ins for
    its shape propagation, which ``meta`` makes free)."""

    def __init__(self):
        super().__init__()
        self.coll = {k: 0.0 for k in KINDS}
        self.cross_node = 0.0
        self.cross_pod = 0.0
        self.live = 0
        self.peak = 0
        self._seen: set = set()

    def _free(self, key, n):
        self._seen.discard(key)
        self.live -= n

    def hold(self, t):
        st = t.untyped_storage()
        key = st._cdata
        if key in self._seen:
            return
        n = st.nbytes()
        self._seen.add(key)
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key, n)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from repro_torch.distribution.sharding import is_dtensor
        if any(is_dtensor(t) for t in _tensors((args, kwargs))):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if isinstance(func, torch._ops.HigherOrderOperator):
            return out
        kind = _kind(func._overloadpacket.__name__)
        if kind is not None and "wait" not in func.__name__:
            # the result: a functional collective's output, or the buffer
            # a c10d collective writes (its first tensor argument)
            res = _tensors(out) if func.namespace == "_c10d_functional" \
                else _tensors(args)[:1]
            for t in res:
                self.hold(t)
            n = sum(_nbytes(t) for t in res)
            ranks = _group_ranks(list(args) + list(kwargs.values()))
            self.coll[kind] += n
            if len({r // NODE_RANKS for r in ranks}) > 1:
                self.cross_node += n
            if len({r // POD_RANKS for r in ranks}) > 1:
                self.cross_pod += n
        return out


@contextlib.contextmanager
def _quiet():
    """DTensor's advice on sequential all-reduces, once an op, silenced."""
    log = logging.getLogger("torch.distributed.tensor._redistribute")
    level = log.level
    log.setLevel(logging.ERROR)
    try:
        yield
    finally:
        log.setLevel(level)


@dataclasses.dataclass
class Counts:
    """What :func:`count` saw: FLOPs and bytes on the rank, collectives by
    kind, and the peak of the live bytes the work allocated."""

    flops: float = 0.0
    bytes_accessed: float = 0.0
    collectives: dict = dataclasses.field(default_factory=dict)
    temp_bytes: float = 0.0


@contextlib.contextmanager
def count():
    """Count the work inside by the census's rules (DTensors on a mesh of
    the fake world, or plain tensors); the :class:`Counts` it yields is
    filled in on exit."""
    res = Counts()
    local = _Local()
    per_dev = _PerDevice(local)
    from repro_torch.distribution.sharding import plain_as_replicated
    with _quiet(), local, per_dev, plain_as_replicated():
        yield res
    res.flops, res.bytes_accessed = per_dev.flops, per_dev.bytes
    res.temp_bytes = float(local.peak)
    res.collectives = {k: v for k, v in local.coll.items() if v}
    res.collectives.update(total=sum(local.coll.values()),
                           cross_node=local.cross_node,
                           cross_pod=local.cross_pod)


def _local_bytes(tree) -> int:
    from repro_torch.distribution.sharding import is_dtensor
    return sum(_nbytes(t.to_local() if is_dtensor(t) else t)
               for t in _tensors(tree))


def _step_builder(model, shape_cfg, mesh, microbatches=1):
    """``(fn, args, param tree)`` of this shape's step on ``meta``, the
    arguments laid out by their specs (the train step's state, tokens and
    labels, over ``microbatches``; or the parameters, tokens or token,
    cache and position)."""
    from repro_torch.distribution import sharding as sh
    from repro_torch.launch.specs import input_specs, param_shapes
    from repro_torch.training.optimizer import OptCfg, init_opt_state
    from repro_torch.training.train import TrainState, build_train_step
    args, specs = input_specs(model, shape_cfg)
    placed = {k: sh.param_sharding_tree(v, specs[k], mesh)
              for k, v in args.items()}
    params = sh.param_sharding_tree(param_shapes(model),
                                    model.param_specs(), mesh)
    if shape_cfg.kind == "train":
        state = TrainState(params, init_opt_state(params), None)
        return (build_train_step(model, OptCfg(), microbatches=microbatches),
                (state, placed["tokens"], placed["labels"]), params)
    if shape_cfg.kind == "prefill":
        return (model.prefill, (params, placed["tokens"], placed["cache"]),
                params)
    return (model.decode_step,
            (params, placed["tok"], placed["cache"], placed["pos"]), params)


def _trace(cfg, shape_cfg, mesh, ctx, microbatches=1) -> dict:
    """One trace of the step at ``cfg``'s depth: the per-device terms."""
    from repro_torch.distribution import sharding as sh
    from repro_torch.models.transformer import build_model
    with sh.sharding_ctx(ctx):
        model = build_model(cfg, "meta")
        fn, args, params = _step_builder(model, shape_cfg, mesh,
                                         microbatches)
        with count() as c:
            out = fn(*args)
        del out
    return dict(dataclasses.asdict(c), arg_bytes=float(_local_bytes(args)),
                param_bytes=float(_local_bytes(params)))


def _fit(a: dict, b: dict, u: int, L: int) -> dict:
    """The reference's affine fit: ``a`` traced at ``u`` layers, ``b`` at
    ``2u``, each traced term taken to ``L``."""
    def ext(x, y):
        return x + (y - x) / u * (L - u)
    out = {k: ext(a[k], b[k]) for k in ("flops", "bytes_accessed",
                                        "temp_bytes")}
    out["collectives"] = {k: ext(a["collectives"].get(k, 0.0),
                                 b["collectives"].get(k, 0.0))
                          for k in sorted(set(a["collectives"])
                                          | set(b["collectives"]))}
    return out


def fitted(a: dict, b: dict, u: int, L: int, args: dict) -> dict:
    """A cell's terms at ``L`` layers from its traces at ``u`` (``a``) and
    ``2u`` (``b``) layers (rows or :func:`_trace`'s terms) and ``args``,
    its arguments' bytes at ``L`` (:func:`arg_census`)."""
    out = dict(_fit(a, b, u, L), arg_bytes=args["arg_bytes"],
               param_bytes=args["param_bytes"])
    out["peak_memory_bytes"] = out["arg_bytes"] + out["temp_bytes"]
    return out


def _configure(arch, n_layers, attn_impl, cfg_overrides):
    from repro_torch import configs
    cfg = configs.get(arch)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    if attn_impl is not None:
        cfg = dataclasses.replace(cfg, attn_impl=attn_impl)
    if cfg_overrides:
        # nested dataclass fields addressed as "moe.capacity_factor"
        plain = {k: v for k, v in cfg_overrides.items() if "." not in k}
        cfg = dataclasses.replace(cfg, **plain)
        for k, v in cfg_overrides.items():
            if "." in k:
                head, leaf = k.split(".", 1)
                sub = dataclasses.replace(getattr(cfg, head), **{leaf: v})
                cfg = dataclasses.replace(cfg, **{head: sub})
    return cfg


def run_cell(arch: str, shape_name: str, *, multi_pod: bool,
             n_layers: int | None = None,
             attn_impl: str | None = "xla_unrolled",
             rule_overrides: dict | None = None,
             cfg_overrides: dict | None = None) -> CellResult:
    """One cell's census on rank 0 of a fake world of 256 (``multi_pod``:
    512) ranks: traced at ``n_layers`` layers, or, with ``None``, at
    ``unit`` and ``2 · unit`` and fitted to the full depth."""
    from repro_torch import configs
    from repro_torch.configs.shapes import SHAPES, applicable
    from repro_torch.launch.mesh import make_ctx, make_production_mesh
    from repro_torch.roofline.analysis import _unit
    mesh_name = "2x16x16" if multi_pod else "16x16"
    full = configs.get(arch)
    shape_cfg = SHAPES[shape_name]
    ok, reason = applicable(full, shape_cfg)
    res = CellResult(arch=arch, shape=shape_name, mesh=mesh_name,
                     status="skip", reason=reason)
    if not ok:
        return res
    t0 = time.time()
    try:
        start_world(512 if multi_pod else 256)
        mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
        top = _configure(arch, n_layers, attn_impl, cfg_overrides)
        ctx = make_ctx(mesh, top, shape_cfg, **(rule_overrides or {}))
        if n_layers is not None:
            terms = _trace(top, shape_cfg, mesh, ctx)
            terms["peak_memory_bytes"] = (terms["arg_bytes"]
                                          + terms["temp_bytes"])
        else:
            u = _unit(full)
            a, b = (_trace(_configure(arch, d, attn_impl, cfg_overrides),
                           shape_cfg, mesh, ctx) for d in (u, 2 * u))
            # the arguments at full depth, read from the specs
            terms = fitted(a, b, u, full.n_layers,
                           _arg_bytes(top, shape_cfg, mesh, ctx))
        res.status = "ok"
        res.n_layers = top.n_layers
        for k, v in terms.items():
            setattr(res, k, v)
    except Exception as e:                                 # noqa: BLE001
        res.status = "fail"
        res.reason = f"{type(e).__name__}: {e}"[:500]
    res.seconds = time.time() - t0
    return res


def arg_census(arch: str, shape_name: str, *, multi_pod: bool) -> dict:
    """``{"arg_bytes", "param_bytes"}`` of a cell at full depth on rank 0
    of the fake world, read from the specs' placements (no trace)."""
    from repro_torch import configs
    from repro_torch.configs.shapes import SHAPES
    from repro_torch.launch.mesh import make_ctx, make_production_mesh
    start_world(512 if multi_pod else 256)
    mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
    cfg, shape_cfg = configs.get(arch), SHAPES[shape_name]
    return _arg_bytes(cfg, shape_cfg, mesh, make_ctx(mesh, cfg, shape_cfg))


def run_one_device(cfg, shape_cfg, *, microbatches: int = 1) -> CellResult:
    """The census of ``cfg``'s step for ``shape_cfg`` (any shape: a
    ``ShapeCfg``) on a 1 × 1 world, every spec's axes of size 1: one
    device's work, fitted over ``unit`` and ``2 · unit`` layers to
    ``cfg``'s depth (the roofline of a step run on one card)."""
    from repro_torch.launch.mesh import make_ctx, make_mesh
    from repro_torch.roofline.analysis import _unit
    res = CellResult(arch=cfg.name, shape=shape_cfg.name, mesh="1x1",
                     status="fail", n_layers=cfg.n_layers)
    t0 = time.time()
    start_world(1)
    mesh = make_mesh((1, 1), ("data", "model"), "cpu")
    ctx = make_ctx(mesh, cfg, shape_cfg)
    u = _unit(cfg)
    a, b = (_trace(dataclasses.replace(cfg, n_layers=d), shape_cfg, mesh,
                   ctx, microbatches) for d in (u, 2 * u))
    for k, v in fitted(a, b, u, cfg.n_layers,
                       _arg_bytes(cfg, shape_cfg, mesh, ctx)).items():
        setattr(res, k, v)
    res.status = "ok"
    res.seconds = time.time() - t0
    return res


def _arg_bytes(cfg, shape_cfg, mesh, ctx) -> dict:
    """The step's arguments' and parameters' local bytes at ``cfg``'s
    depth (no trace)."""
    from repro_torch.distribution import sharding as sh
    from repro_torch.models.transformer import build_model
    with sh.sharding_ctx(ctx):
        _, args, params = _step_builder(build_model(cfg, "meta"), shape_cfg,
                                        mesh)
        return dict(arg_bytes=float(_local_bytes(args)),
                    param_bytes=float(_local_bytes(params)))


def _run_cell_args(cell) -> CellResult:
    arch, shape, multi_pod = cell
    return run_cell(arch, shape, multi_pod=multi_pod)


def iter_cells():
    from repro_torch import configs
    from repro_torch.configs.shapes import SHAPES
    for arch in configs.ARCH_NAMES:
        for shape in SHAPES:
            yield arch, shape


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="both")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun.json")
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells traced at once, each in a process (and a "
                         "fake world) of its own")
    args = ap.parse_args(argv)

    cells = list(iter_cells()) if args.all else [(args.arch, args.shape)]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    todo = [(arch, shape, mp) for arch, shape in cells for mp in meshes]
    rows = []
    t0 = time.time()
    with contextlib.ExitStack() as stack:
        if args.jobs > 1:
            import multiprocessing
            pool = stack.enter_context(multiprocessing.get_context(
                "spawn").Pool(args.jobs, maxtasksperchild=1))
            results = pool.imap(_run_cell_args, todo)
        else:
            results = map(_run_cell_args, todo)
        for r in results:
            coll = r.collectives.get("total", 0) / 1e6
            print(f"{r.arch:18s} {r.shape:12s} {r.mesh:8s} {r.status:5s} "
                  f"t={r.seconds:6.1f}s flops/dev={r.flops:.3e} "
                  f"peak_mem/dev={r.peak_memory_bytes/2**30:6.2f}GiB "
                  f"coll={coll:9.1f}MB {r.reason[:60]}",
                  flush=True)
            rows.append(r.row())
    print(f"{len(rows)} cells in {time.time() - t0:.1f} s (host wall clock)",
          flush=True)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
        print(f"wrote {args.out}")
    n_fail = sum(1 for r in rows if r["status"] == "fail")
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
