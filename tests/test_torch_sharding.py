"""The port's sharding rules, contexts and specs against the JAX package,
with no devices: both sides read only a mesh's axis names and sizes, so
the production meshes (256 and 512 ranks) are stand-ins here
(``repro_torch.distribution.sharding.MeshShape`` and an object with the
same ``shape`` and ``axis_names`` on the reference's side, whose
``make_ctx`` and ``pspec`` read nothing else).

* ``make_rules`` for every flag combination;
* ``make_ctx`` for the ten configs × the four shapes × single and multi
  pod;
* ``param_specs`` and ``cache_specs`` leaf for leaf under those contexts
  (a port layer's spec is the reference's stacked spec without its
  leading ``None``; the caches keep the stacked layout);
* ``launch/specs.py``'s ``meta`` shapes against ``jax.eval_shape`` and its
  input specs against the reference's;
* the named errors: ``--mesh single`` on a one-process world.
"""
import contextlib
import dataclasses
import itertools

import jax
import jax.numpy as jnp
import pytest
from jax.sharding import PartitionSpec as P

from repro import configs as jconfigs
from repro.distribution import sharding as jsh
from repro.launch import mesh as jmesh
from repro.launch import specs as jspecs
from repro.models import transformer as jtr
from repro_torch import configs
from repro_torch.distribution import sharding as tsh
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import specs as tspecs
from repro_torch.models import transformer as ttr
from repro_torch.training.tree import flatten_with_paths

ARCHS = configs.ARCH_NAMES
SHAPES = tuple(configs.SHAPES)
FLAGS = ("multi_pod", "fsdp", "shard_heads", "shard_kv_heads", "seq_kv_data")


class _RefMesh:
    """The reference mesh's ``shape`` and ``axis_names``, all its
    ``make_ctx`` and ``pspec`` read."""

    def __init__(self, shape: dict):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)


def _norm(entry):
    """A spec entry with a one-axis tuple read as the axis."""
    if isinstance(entry, tuple) and len(entry) == 1:
        return entry[0]
    return entry


def _spec(s) -> tuple:
    return tuple(_norm(e) for e in s)


@contextlib.contextmanager
def _ref_ctx(ctx):
    tok = jsh._ctx.set(ctx)
    try:
        yield
    finally:
        jsh._ctx.reset(tok)


def _ctxs(arch, shape, multi_pod):
    mesh = tmesh.production_shape(multi_pod)
    t = tmesh.make_ctx(mesh, configs.get(arch), configs.SHAPES[shape])
    j = jmesh.make_ctx(_RefMesh(mesh.shape), jconfigs.get(arch),
                       jconfigs.SHAPES[shape])
    return t, j


@pytest.mark.parametrize("flags", list(itertools.product(
    (False, True), repeat=len(FLAGS))),
    ids=lambda f: "-".join(n for n, v in zip(FLAGS, f) if v) or "none")
def test_make_rules_equal(flags):
    kw = dict(zip(FLAGS, flags))
    assert tsh.make_rules(**kw) == jsh.make_rules(**kw)


@pytest.mark.parametrize("multi_pod", (False, True), ids=("single", "multi"))
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_make_ctx_rules_equal(arch, shape, multi_pod):
    t, j = _ctxs(arch, shape, multi_pod)
    assert t.rules == dict(j.rules)
    assert (t.dp_axes, t.tp_axis, t.pod_axis) == \
        (j.dp_axes, j.tp_axis, j.pod_axis)
    with tsh.sharding_ctx(t), _ref_ctx(j):
        for name in t.rules:
            assert tsh.axis_size(name) == jsh.axis_size(name), name
        assert tsh.tp_size() == jsh.tp_size()
        assert tsh.dp_size() == jsh.dp_size()
        assert tsh.phys("seq_kv", "seq_kv_tp") == \
            jsh.phys("seq_kv", "seq_kv_tp")


def _ref_leaves(tree) -> dict:
    """``{path: spec}`` of a reference spec tree."""
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda s: isinstance(s, P))
    return {tuple(str(getattr(k, "key", getattr(k, "idx", k)))
                  for k in path): s for path, s in flat}


def _port_leaves(tree) -> dict:
    return {path: s for path, s in flatten_with_paths(tree)}


def _unstack(ref: dict, n_layers: int) -> dict:
    """The reference's stacked ``layers`` specs per layer, without the
    leading ``None`` (the port's layout)."""
    out = {}
    for path, s in ref.items():
        if path[0] == "layers":
            assert len(s) == 0 or s[0] is None, (path, s)
            for i in range(n_layers):
                out[("layers", str(i), *path[1:])] = tuple(s)[1:]
        else:
            out[path] = tuple(s)
    return out


@pytest.mark.parametrize("multi_pod", (False, True), ids=("single", "multi"))
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_cache_specs_equal(arch, shape, multi_pod):
    t, j = _ctxs(arch, shape, multi_pod)
    cfg = configs.get(arch)
    sc = configs.SHAPES[shape]
    tm = ttr.build_model(cfg, "meta")
    jm = jtr.build_model(jconfigs.get(arch))
    with tsh.sharding_ctx(t), _ref_ctx(j):
        tp = _port_leaves(tm.param_specs())
        jp = _unstack(_ref_leaves(jm.param_specs()), cfg.n_layers)
        tc = _port_leaves(tm.cache_specs(sc.global_batch, sc.seq_len))
        jc = _ref_leaves(jm.cache_specs(sc.global_batch, sc.seq_len))
    assert set(tp) == set(jp)
    for path in jp:
        assert _spec(tp[path]) == _spec(jp[path]), path
    assert set(tc) == set(jc)
    for path in jc:
        assert _spec(tc[path]) == _spec(jc[path]), path


def test_specs_without_context_are_empty():
    for arch in ARCHS:
        m = ttr.build_model(configs.get_smoke(arch), "meta")
        assert all(s == () for _, s in flatten_with_paths(m.param_specs()))


def _shape_leaves(tree, ref: bool) -> dict:
    if ref:
        flat, _ = jax.tree_util.tree_flatten_with_path(tree)
        return {tuple(str(getattr(k, "key", getattr(k, "idx", k)))
                      for k in path): (tuple(a.shape), str(a.dtype))
                for path, a in flat}
    return {path: (tuple(a.shape), str(a.dtype).replace("torch.", ""))
            for path, a in flatten_with_paths(tree)}


def _unstack_shapes(ref: dict, n_layers: int) -> dict:
    out = {}
    for path, (shape, dt) in ref.items():
        if path[0] == "layers":
            assert shape[0] == n_layers
            for i in range(n_layers):
                out[("layers", str(i), *path[1:])] = (shape[1:], dt)
        else:
            out[path] = (shape, dt)
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_param_shapes_on_meta_equal_eval_shape(arch):
    cfg = configs.get(arch)
    got = tspecs.param_shapes(ttr.build_model(cfg, "meta"))
    assert all(a.device.type == "meta" for _, a in flatten_with_paths(got))
    # x64 off, as another test file in the same worker may have turned it
    # on (the reference's placeholder norm takes the default dtype)
    with jax.enable_x64(False):
        want = jspecs.param_shapes(jtr.build_model(jconfigs.get(arch)))
    assert _shape_leaves(got, False) == \
        _unstack_shapes(_shape_leaves(want, True), cfg.n_layers)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_equal(arch, shape):
    t, j = _ctxs(arch, shape, False)
    sc = configs.SHAPES[shape]
    tm = ttr.build_model(configs.get(arch), "meta")
    jm = jtr.build_model(jconfigs.get(arch))
    with tsh.sharding_ctx(t), _ref_ctx(j), jax.enable_x64(False):
        targs, tspec = tspecs.input_specs(tm, sc)
        jargs, jspec = jspecs.input_specs(jm, jconfigs.SHAPES[shape])
    assert _shape_leaves(targs, False) == _shape_leaves(jargs, True)
    tl, jl = _port_leaves(tspec), _ref_leaves(jspec)
    assert set(tl) == set(jl)
    for path in jl:
        assert _spec(tl[path]) == _spec(jl[path]), path


def test_production_mesh_refuses_a_one_process_world():
    with pytest.raises(tmesh.MeshSizeError, match="256 ranks"):
        tmesh.make_production_mesh(device_type="cpu")
    with pytest.raises(tmesh.MeshSizeError, match="512 ranks"):
        tmesh.make_production_mesh(multi_pod=True, device_type="cpu")


@pytest.mark.parametrize("mesh", ("single", "multi"))
def test_launcher_mesh_refuses_a_one_process_world(mesh, tmp_path, capsys):
    from repro_torch.launch import train as launcher
    with pytest.raises(tmesh.MeshSizeError):
        launcher.main(["--smoke", "--device", "cpu", "--mesh", mesh,
                       "--steps", "2", "--ckpt-dir", str(tmp_path)])
    assert not list(tmp_path.iterdir())       # stopped before any step
    assert "steps in" not in capsys.readouterr().out


def test_compress_pods_needs_the_multi_pod_mesh(tmp_path):
    from repro_torch.launch import train as launcher
    from repro_torch.training.train import CompressedStepError
    with pytest.raises(CompressedStepError):
        launcher.main(["--smoke", "--device", "cpu", "--compress-pods",
                       "--steps", "2", "--ckpt-dir", str(tmp_path)])


def test_layer_modes():
    cfg = configs.get_smoke("olmo-1b")
    for mode in ttr.LAYER_MODES:
        assert ttr.build_model(cfg, "cpu", layer_mode=mode).cfg is cfg
    with pytest.raises(ValueError):
        ttr.build_model(cfg, "cpu", layer_mode="vmap")


def test_placements_of_specs():
    from torch.distributed.tensor import Replicate, Shard

    class _Mesh:
        mesh_dim_names = ("pod", "data", "model")

        def size(self, i):
            return (2, 1, 4)[i] if self.one else 2

        one = False

    m = _Mesh()
    assert tsh.placements(tsh.Spec(("pod", "data"), None, "model"), m) == \
        (Shard(0), Shard(0), Shard(2))
    assert tsh.placements(tsh.Spec(None, ("data", "model")), m) == \
        (Replicate(), Shard(1), Shard(1))
    assert tsh.placements(tsh.Spec(), m) == (Replicate(),) * 3
    with pytest.raises(ValueError):
        tsh.placements(tsh.Spec(("model", "data")), m)
    with pytest.raises(ValueError):
        tsh.placements(tsh.Spec("data", "data"), m)
    m.one = True       # a mesh dim of size 1: replicated, the same layout
    assert tsh.placements(tsh.Spec(("pod", "data"), None, "model"), m) == \
        (Shard(0), Replicate(), Shard(2))
