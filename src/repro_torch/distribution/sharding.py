"""Logical-axis sharding context on DTensor (counterpart of
``repro/distribution/sharding.py``).

Model code never names mesh axes.  It annotates tensors with *logical*
dimension names (``shard(x, "batch", "seq", "embed")``) and the launcher
installs a :class:`ShardCtx` that maps logical names to the axes of a
``torch.distributed.device_mesh.DeviceMesh``.  Outside any context the
annotations are no-ops, so the same model code runs on one device (the
tests, serving) and sharded (the launcher's meshes) unchanged.

What stands for what:

* a ``DeviceMesh`` with named dims for the reference's ``jax.sharding.Mesh``;
* a spec — a tuple with one entry per tensor dim, each ``None``, a mesh
  axis name or a tuple of them, as :func:`pspec` returns it — for
  ``PartitionSpec``; :func:`placements` turns it into DTensor placements
  (``Shard(d)`` on every mesh dim that dim ``d`` maps to, ``Replicate()``
  elsewhere);
* :func:`shard` (``DTensor.redistribute``) for
  ``with_sharding_constraint``: a DTensor is moved to the spec's
  placements, a plain tensor under a context is taken as the same full
  value on every rank and cut to them;
* the reference's ``shard_map_compat`` has no torch meaning and is not
  ported: its manual regions are :func:`to_local_as` (a DTensor's local
  shard in a given layout) and :func:`from_local_as` (the way back), with
  explicit collectives over ``mesh.get_group(axis)`` in between
  (``repro_torch.models.attention``'s seq-sharded flash-decodes,
  ``repro_torch.models.moe.moe_ep``, the compressed train step).

Logical axis vocabulary (the reference's):

==============  ==========================================================
``batch``       global batch — data parallel (``("pod","data")`` multi-pod)
``seq``         sequence — unsharded by default; ``seq_kv`` may map to
                ``data`` for long-context flash-decode merging
``embed``       d_model of activations — unsharded (activations replicate)
``heads``       attention query heads — tensor parallel
``kv_heads``    attention kv heads — tensor parallel when divisible
``ff``          MLP hidden — tensor parallel
``vocab``       embedding/logits vocabulary — tensor parallel
``expert``      MoE expert dim — expert parallel (maps to ``model``)
``fsdp``        parameter dim sharded over the data axis (ZeRO-3 style)
``tokens_tp``   token dim inside EP routing — maps to ``model``
``state``       recurrent state channels (RWKV/Mamba) — tensor parallel
==============  ==========================================================

Two ranks that share one card talk over ``gloo``.  torch 2.11's
functional collectives, which DTensor's redistributions call, crash in
``gloo``'s CUDA all-gather; :func:`route_functional_collectives` sends
them through c10d's own collectives, which carry CUDA tensors over
``gloo`` (through the host) correctly.
"""
from __future__ import annotations

import collections
import contextlib
import contextvars
import dataclasses
from typing import Any, Mapping

import torch
import torch.distributed as dist

AxisVal = Any  # str | tuple[str, ...] | None


def mesh_axes(mesh) -> dict:
    """``{axis name: size}`` of a ``DeviceMesh``, or of a
    :class:`MeshShape` (the production meshes' shapes, read where no
    process group of that size exists)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return dict(mesh.shape)


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A mesh's axis names and sizes, with no process group behind it:
    what :func:`repro_torch.launch.mesh.make_ctx` and the specs read."""

    shape: Mapping[str, int]


@dataclasses.dataclass(frozen=True)
class ShardCtx:
    mesh: Any                      # DeviceMesh (or MeshShape for specs)
    rules: Mapping[str, AxisVal]
    # physical axis names for the manual regions' collectives
    dp_axes: tuple[str, ...] = ("data",)
    tp_axis: str = "model"
    pod_axis: str | None = None

    def axis_size(self, logical: str) -> int:
        phys_ = self.rules.get(logical)
        if phys_ is None:
            return 1
        if isinstance(phys_, str):
            phys_ = (phys_,)
        shape = mesh_axes(self.mesh)
        n = 1
        for a in phys_:
            n *= shape[a]
        return n


_ctx: contextvars.ContextVar[ShardCtx | None] = contextvars.ContextVar(
    "repro_torch_shard_ctx", default=None)


def current_ctx() -> ShardCtx | None:
    return _ctx.get()


@contextlib.contextmanager
def sharding_ctx(ctx: ShardCtx):
    tok = _ctx.set(ctx)
    try:
        yield ctx
    finally:
        _ctx.reset(tok)


@contextlib.contextmanager
def no_sharding_ctx():
    """Suspend logical-axis constraints (``shard()`` becomes a no-op)."""
    tok = _ctx.set(None)
    try:
        yield
    finally:
        _ctx.reset(tok)


class Spec(tuple):
    """A spec: one entry a tensor dim, each ``None``, a mesh axis name or a
    tuple of them (the reference's ``PartitionSpec``).  A leaf of the
    port's trees (:mod:`repro_torch.training.tree`), not a sequence."""

    _tree_leaf = True

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"Spec{tuple.__repr__(self)}"


_replicating: contextvars.ContextVar[bool] = contextvars.ContextVar(
    "repro_torch_plain_as_replicated", default=False)


@contextlib.contextmanager
def plain_as_replicated():
    """Inside: a plain tensor met beside a DTensor (a position index, a
    mask, a learning rate, an unsharded weight) is taken as the same full
    value on every rank (torch's ``implicit_replication``, entered once:
    torch's own context resets its flag on exit, so nesting it would end
    the outer one early)."""
    if _replicating.get():
        yield
        return
    from torch.distributed.tensor.experimental import implicit_replication
    tok = _replicating.set(True)
    try:
        with implicit_replication():
            yield
    finally:
        _replicating.reset(tok)


def pspec(*logical: str | None) -> Spec:
    """Translate logical dim names into a spec under the context (an
    empty one without it, as the reference's ``P()``)."""
    ctx = _ctx.get()
    if ctx is None:
        return Spec()
    return Spec(*(ctx.rules.get(l) if l else None for l in logical))


def placements(spec, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: ``Shard(d)`` on each
    mesh dim that tensor dim ``d`` maps to, ``Replicate()`` elsewhere (and
    on a mesh dim of size 1, where the two are the same layout).  A dim
    over several mesh axes is split major-first in mesh order, as the
    reference's tuple entries are."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, axes in enumerate(spec):
        if axes is None:
            continue
        axes = axes if isinstance(axes, tuple) else (axes,)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: axes {axes} of dim {d} are not "
                             f"in the mesh's order {names}")
        for i in idx:
            if not isinstance(out[i], Replicate):
                raise ValueError(f"spec {spec}: mesh axis {names[i]} "
                                 f"shards two dims")
            out[i] = Shard(d)
    return tuple(Replicate() if p.is_shard() and mesh.size(i) == 1 else p
                 for i, p in enumerate(out))


_DTENSOR: list = []


def is_dtensor(x) -> bool:
    """Whether ``x`` is a DTensor (the class is imported at the first
    call, and only then: the unsharded paths ask on every layer)."""
    if not _DTENSOR:
        from torch.distributed.tensor import DTensor
        _DTENSOR.append(DTensor)
    return isinstance(x, _DTENSOR[0])


def spec_of(x) -> tuple:
    """The physical spec of a DTensor's placements (its dims' mesh axes,
    major first): the inverse of :func:`placements`."""
    spec = [()] * x.ndim
    for name, p in zip(x.device_mesh.mesh_dim_names, x.placements):
        if p.is_shard():
            spec[p.dim] = (*spec[p.dim], name)
    return tuple(None if not a else a[0] if len(a) == 1 else a for a in spec)


def n_shards(x, dim: int) -> int:
    """How many pieces a DTensor's ``dim`` is cut into (1 for a plain
    tensor)."""
    if not is_dtensor(x):
        return 1
    n = 1
    for i, p in enumerate(x.placements):
        if p.is_shard() and p.dim == dim % x.ndim:
            n *= x.device_mesh.size(i)
    return n


def whole_dim(x, dim: int):
    """``x`` with ``dim`` gathered (a DTensor's other dims keep their
    layout; a plain tensor as it is)."""
    if n_shards(x, dim) == 1:
        return x
    spec = list(spec_of(x))
    spec[dim % x.ndim] = None
    return redistribute(x, Spec(*spec), x.device_mesh)


def replicated(x, mesh):
    """A plain tensor that every rank holds whole, as a replicated
    DTensor on ``mesh`` (no communication)."""
    from torch.distributed.tensor import DTensor, Replicate
    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def redistribute(x, spec, mesh=None):
    """``x`` moved to ``spec``'s placements on ``mesh`` (the context's by
    default); a plain tensor is taken as replicated first."""
    mesh = current_ctx().mesh if mesh is None else mesh
    if not is_dtensor(x):
        x = replicated(x, mesh)
    assert x.ndim == len(spec), (tuple(x.shape), spec)
    return x.redistribute(mesh, placements(spec, mesh))


def shard(x, *logical: str | None):
    """Constrain ``x``'s sharding by logical dim names (no-op w/o
    context)."""
    ctx = _ctx.get()
    if ctx is None:
        return x
    assert x.ndim == len(logical), (tuple(x.shape), logical)
    return redistribute(x, pspec(*logical), ctx.mesh)


def to_local_as(x, spec, work=None):
    """This rank's shard of ``x`` laid out by the physical ``spec`` (the
    entry of a manual region); without a context, ``x``.

    ``work`` is the spec of the region's work (its activations).  On a
    mesh axis that ``work`` splits and ``spec`` does not, each rank uses
    the whole of ``x`` on its own part of the work (a weight on its slice
    of the batch, channels shared by its local heads), so the gradient a
    rank takes back is a part of the whole: it leaves the region as
    ``Partial`` and is summed over that axis."""
    ctx = _ctx.get()
    if ctx is None:
        return x
    d = redistribute(x, spec)
    split = {a for e in (work or ()) if e
             for a in ((e,) if isinstance(e, str) else e)}
    if not split:
        return _contiguous_grad(d.to_local())
    from torch.distributed.tensor import Partial
    names = ctx.mesh.mesh_dim_names
    return _contiguous_grad(d.to_local(grad_placements=[
        Partial() if names[i] in split and not p.is_shard()
        and ctx.mesh.size(i) > 1 else p
        for i, p in enumerate(d.placements)]))


class _ContiguousGrad(torch.autograd.Function):
    """The identity, whose backward hands on a contiguous gradient."""

    @staticmethod
    def forward(ctx, t):
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def _contiguous_grad(t):
    """``t``, with the gradient a region computes for it made contiguous
    before it leaves the region: ``to_local``'s backward wraps the local
    gradient as the DTensor's shard as it is, and DTensor views a shard by
    its global layout (a transposed local gradient failed the ``view`` in
    the backward of the projection before it)."""
    return _ContiguousGrad.apply(t) if t.requires_grad else t


def from_local_as(t, spec, shape=None):
    """The DTensor whose shard on this rank is ``t``, laid out by the
    physical ``spec`` (the exit of a manual region).  Its global shape is
    ``shape``, or ``t``'s with every sharded dim times its mesh axes'
    sizes (even shards)."""
    ctx = _ctx.get()
    if ctx is None:
        return t
    from torch.distributed.tensor import DTensor
    mesh = ctx.mesh
    pl = placements(spec, mesh)
    if shape is None:
        shape = list(t.shape)
        for i, p in enumerate(pl):
            if p.is_shard():
                shape[p.dim] *= mesh.size(i)
    shape = torch.Size(shape)
    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(t.contiguous(), mesh, pl, run_check=False,
                              shape=shape, stride=stride)


def heads_over_model(n_heads: int) -> str | None:
    """``"model"`` when ``n_heads`` split evenly over the heads axes (the
    recurrent states' rule), else ``None``."""
    ok = n_heads % max(axis_size("heads"), 1) == 0
    return "model" if ok and axis_size("heads") > 1 else None


def head_region(n_heads: int) -> tuple:
    """``(batch, heads)``: the physical axes of a manual region on each
    rank's local heads of ``n_heads`` (``heads`` is ``None`` where they do
    not split: every rank then runs all of them); ``(None, None)`` without
    a context."""
    if _ctx.get() is None:
        return None, None
    return pspec("batch")[0], heads_over_model(n_heads)


def axis_index(axes) -> int:
    """This rank's position along ``axes`` (major first) of the
    context's mesh."""
    mesh = _ctx.get().mesh
    names = list(mesh.mesh_dim_names)
    idx = 0
    for a in ((axes,) if isinstance(axes, str) else axes):
        idx = idx * mesh.size(names.index(a)) + mesh.get_local_rank(a)
    return idx


def all_reduce(t, op: str, axes):
    """``t`` reduced (``"sum"`` or ``"max"``) over the context's mesh
    ``axes``, in place, one axis after another (the reference's
    ``psum``/``pmax`` over several axes)."""
    mesh = _ctx.get().mesh
    red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
    for a in ((axes,) if isinstance(axes, str) else axes):
        dist.all_reduce(t, op=red, group=mesh.get_group(a))
    return t


def named_sharding(*logical: str | None):
    """``(mesh, placements)`` of the logical spec under the context, or
    ``None`` without one."""
    ctx = _ctx.get()
    if ctx is None:
        return None
    return NamedSharding(ctx.mesh, pspec(*logical))


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A mesh and a spec on it: where one leaf lives."""

    mesh: Any
    spec: tuple

    @property
    def placements(self) -> tuple:
        return placements(self.spec, self.mesh)


def tp_size() -> int:
    ctx = _ctx.get()
    return 1 if ctx is None else mesh_axes(ctx.mesh)[ctx.tp_axis]


def axis_size(logical: str) -> int:
    """Product of mesh-axis sizes a logical name maps to (1 w/o ctx)."""
    ctx = _ctx.get()
    return 1 if ctx is None else ctx.axis_size(logical)


def phys(*logical: str) -> tuple | None:
    """Concatenate the physical axes of several logical names (one dim).

    Used where a single tensor dim carries several logical shardings
    (e.g. a decode cache sequence dim sharded over data *and* model)."""
    ctx = _ctx.get()
    if ctx is None:
        return None
    axes: list = []
    for l in logical:
        a = ctx.rules.get(l)
        if a is None:
            continue
        axes.extend(a if isinstance(a, tuple) else (a,))
    return tuple(axes) if axes else None


def dp_size() -> int:
    ctx = _ctx.get()
    if ctx is None:
        return 1
    shape = mesh_axes(ctx.mesh)
    n = 1
    for a in ctx.dp_axes:
        n *= shape[a]
    return n


# ---------------------------------------------------------------------------
# Rules construction
# ---------------------------------------------------------------------------

def make_rules(*, multi_pod: bool = False, fsdp: bool = False,
               shard_heads: bool = True, shard_kv_heads: bool = True,
               seq_kv_data: bool = False) -> dict[str, AxisVal]:
    """Standard logical→physical rules for the production meshes.

    ``fsdp`` additionally shards a designated parameter dim over the data
    axis (ZeRO-3) for the ≥14 B archs.  ``shard_heads=False`` keeps
    attention replicated over the model axis (archs whose head count does
    not divide the TP degree and whose attention is a small param
    fraction, e.g. gemma-2b with 8 heads).  ``seq_kv_data=True`` maps the
    KV-cache sequence dim onto the data axis (long-context flash-decode).
    """
    dp: AxisVal = ("pod", "data") if multi_pod else ("data",)
    return {
        "batch": dp,
        "seq": None,
        "embed": None,
        "heads": "model" if shard_heads else None,
        "kv_heads": "model" if (shard_heads and shard_kv_heads) else None,
        "ff": "model",
        "vocab": "model",
        "expert": "model",
        "tokens_tp": "model",
        "state": "model",
        "fsdp": "data" if fsdp else None,
        # serving layout for MoE decode: expert weights sharded on the
        # per-expert ff dim over 'data'; the launcher enables it per shape
        "expert_ff": None,
        "seq_kv": "data" if seq_kv_data else None,
        "seq_kv_tp": "model",    # decode-cache seq dim when kv_heads ∤ TP
        # sequence parallelism of the residual stream; per shape
        "act_seq": None,
    }


def sharding_tree(specs, mesh):
    """A tree of specs as a tree of :class:`NamedSharding` on ``mesh``."""
    from repro_torch.training.tree import tree_map
    return tree_map(lambda s: NamedSharding(mesh, s), specs)


def distribute(x, sh: NamedSharding):
    """The full tensor ``x`` (the same on every rank) as a DTensor laid out
    by ``sh``: each rank keeps its own slice, so the values are ``x``'s
    bit for bit and nothing is sent."""
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(x, sh.mesh, sh.placements, src_data_rank=None)


def param_sharding_tree(tree, specs, mesh):
    """A tree of full tensors distributed leaf by leaf by a tree of specs
    on ``mesh`` (a sharded init equals the one-device init bit for
    bit)."""
    from repro_torch.training.tree import tree_map
    return tree_map(lambda x, s: distribute(x, NamedSharding(mesh, s)),
                    tree, specs)


def full(x):
    """A DTensor's full value on every rank (a plain tensor as it is)."""
    return x.full_tensor() if is_dtensor(x) else x


# ---------------------------------------------------------------------------
# gloo on CUDA tensors
# ---------------------------------------------------------------------------

_ROUTED = []
#: the routed collectives made so far, by name (what a step or a decode
#: step costs in collectives on a routed mesh)
ROUTED_CALLS: collections.Counter = collections.Counter()
_OPS = {"sum": dist.ReduceOp.SUM, "avg": dist.ReduceOp.SUM,
        "max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN}


def _group(name):
    from torch.distributed.distributed_c10d import _resolve_process_group
    return _resolve_process_group(name)


def _all_gather(inp, group_size, group_name):
    ROUTED_CALLS["all_gather"] += 1
    out = inp.new_empty((inp.shape[0] * group_size, *inp.shape[1:]))
    dist.all_gather_into_tensor(out, inp.contiguous(), group=_group(group_name))
    return out


def _mean(out, reduce_op, n):
    """gloo has no average: a sum, then divided by the group's size."""
    return out.div_(n) if reduce_op.lower() == "avg" else out


def _reduce_scatter(inp, reduce_op, group_size, group_name):
    ROUTED_CALLS["reduce_scatter"] += 1
    out = inp.new_empty((inp.shape[0] // group_size, *inp.shape[1:]))
    dist.reduce_scatter_tensor(out, inp.contiguous(),
                               op=_OPS[reduce_op.lower()],
                               group=_group(group_name))
    return _mean(out, reduce_op, group_size)


def _all_to_all(inp, out_splits, in_splits, group_name):
    ROUTED_CALLS["all_to_all"] += 1
    out = inp.new_empty((sum(out_splits), *inp.shape[1:]))
    dist.all_to_all_single(out, inp.contiguous(), list(out_splits),
                           list(in_splits), group=_group(group_name))
    return out


def _all_reduce(inp, reduce_op, group_name):
    ROUTED_CALLS["all_reduce"] += 1
    out = inp.clone()
    group = _group(group_name)
    dist.all_reduce(out, op=_OPS[reduce_op.lower()], group=group)
    return _mean(out, reduce_op, dist.get_world_size(group))


def route_functional_collectives() -> None:
    """Send the CUDA kernels of torch's functional collectives (what
    DTensor redistributes with) through c10d's synchronous collectives.

    For a CUDA mesh over ``gloo``: torch 2.11's functional all-gather
    crashes there (a segfault in ``wait_tensor``), while c10d's
    ``all_gather_into_tensor``, ``reduce_scatter_tensor``,
    ``all_to_all_single`` and ``all_reduce`` carry CUDA tensors through
    gloo as they should.  The tensors stay on the card; gloo stages them
    through the host as it always does.  Idempotent; never called for
    NCCL."""
    if _ROUTED:
        return
    lib = torch.library.Library("_c10d_functional", "IMPL")
    lib.impl("all_gather_into_tensor", _all_gather, "CUDA")
    lib.impl("reduce_scatter_tensor", _reduce_scatter, "CUDA")
    lib.impl("all_to_all_single", _all_to_all, "CUDA")
    lib.impl("all_reduce", _all_reduce, "CUDA")
    _ROUTED.append(lib)
