"""The dry-run census (``repro_torch.launch.dryrun``) on a fake world.

The census starts a fake process group of 256 or 512 ranks in its own
process, so everything that needs the world runs in one subprocess of
this file (:data:`SCRIPT`), never in the test worker; the specs' side of
each check runs here, on stand-in meshes (``MeshShape``).

* olmo-1b's ``decode_32k`` at full depth on 16 × 16 (the counterpart of
  ``tests/test_distributed.py:205-218``): ``ok``, a peak below the H100's
  80 GB, FLOPs counted;
* every arch's per-rank parameter bytes on both meshes, under a train
  and a decode shape's rules, equal to the local shapes the port's specs
  imply (rank 0's shard of each dim: ``ceil`` over each mesh axis on it,
  in mesh order);
* the per-device rule against hand counts: a column-parallel, a
  row-parallel (``Partial``), a replicated and a manual region's product,
  FLOPs and bytes; and olmo-1b's ``decode_32k`` at one layer, whose
  products are counted by hand below;
* the two-point fit (1 and 2 layers) against a direct trace at 3, on
  olmo-1b's ``decode_32k``: FLOPs and collective bytes equal.
"""
import json
import math
import os
import subprocess
import sys

import pytest
import torch

from repro_torch import configs
from repro_torch.configs.shapes import SHAPES
from repro_torch.distribution import sharding as sh
from repro_torch.launch.mesh import make_ctx, production_shape
from repro_torch.launch.specs import param_shapes
from repro_torch.models.transformer import build_model
from repro_torch.training.tree import tree_leaves

SRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src")
RULE_SHAPES = ("train_4k", "decode_32k")
#: the hand-counted products: [B, S, D] tokens, [D, F] and [F, D] weights
B, S, D, F = 32, 64, 256, 512

SCRIPT = """
import json, sys
import torch
from repro_torch import configs
from repro_torch.distribution import sharding as sh
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_production_mesh

out = {}
r = dryrun.run_cell("olmo-1b", "decode_32k", multi_pod=False, n_layers=16)
out["olmo_full"] = r.row()
out["olmo_1"] = dryrun.run_cell("olmo-1b", "decode_32k", multi_pod=False,
                                n_layers=1).row()
out["olmo_2"] = dryrun.run_cell("olmo-1b", "decode_32k", multi_pod=False,
                                n_layers=2).row()
out["olmo_3"] = dryrun.run_cell("olmo-1b", "decode_32k", multi_pod=False,
                                n_layers=3).row()

B, S, D, F = %(shape)s
mesh = make_production_mesh(device_type="cpu")
ctx = sh.ShardCtx(mesh=mesh, rules=sh.make_rules())
meta = lambda *s: torch.empty(s, device="meta")
with sh.sharding_ctx(ctx):
    x = sh.distribute(meta(B, S, D),
                      sh.NamedSharding(mesh, ("data", None, None)))
    w1 = sh.distribute(meta(D, F), sh.NamedSharding(mesh, (None, "model")))
    h = sh.distribute(meta(B, S, F),
                      sh.NamedSharding(mesh, ("data", None, "model")))
    w2 = sh.distribute(meta(F, D), sh.NamedSharding(mesh, ("model", None)))
    xr = sh.distribute(meta(B, S, D), sh.NamedSharding(mesh, (None,) * 3))
    w1r = sh.distribute(meta(D, F), sh.NamedSharding(mesh, (None, None)))
    for name, fn in (("column", lambda: x @ w1), ("row", lambda: h @ w2),
                     ("replicated", lambda: xr @ w1r),
                     ("region", lambda: x.to_local() @ w1.to_local())):
        with dryrun.count() as c:
            y = fn()
        out[name] = dict(flops=c.flops, bytes=c.bytes_accessed,
                         placements=str(getattr(y, "placements", None)))

for multi in (False, True):
    for arch in configs.ARCH_NAMES:
        for shape in %(rule_shapes)s:
            out[f"param/{arch}/{multi}/{shape}"] = dryrun.arg_census(
                arch, shape, multi_pod=multi)["param_bytes"]
print(json.dumps(out))
""" % dict(shape=(B, S, D, F), rule_shapes=RULE_SHAPES)


@pytest.fixture(scope="module")
def census():
    proc = subprocess.run([sys.executable, "-c", SCRIPT],
                          env=dict(os.environ, PYTHONPATH=SRC),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_full_depth_decode_fits(census):
    r = census["olmo_full"]
    assert r["status"] == "ok", r["reason"]
    assert r["n_layers"] == 16
    assert 0 < r["peak_memory_bytes"] < 80e9
    assert r["flops"] > 0 and r["bytes_accessed"] > 0
    assert r["collectives"]["total"] > 0
    # the 16 × 16 mesh stays in one pod; its model groups span two nodes
    assert r["collectives"]["cross_pod"] == 0
    assert r["collectives"]["cross_node"] == r["collectives"]["total"]


def _local_bytes(shape, dtype, spec, axes):
    """Rank 0's shard of a leaf of ``shape`` laid out by ``spec`` on a
    mesh of ``axes`` sizes: each dim split over its mesh axes in mesh
    order, the first piece ``ceil`` of what is left."""
    n = 1
    for d, entry in enumerate(tuple(spec) + (None,) * (len(shape)
                                                       - len(spec))):
        size = shape[d]
        names = () if entry is None else (
            (entry,) if isinstance(entry, str) else entry)
        for a in sorted(names, key=list(axes).index):
            size = math.ceil(size / axes[a])
        n *= size
    return n * torch.empty((), dtype=dtype).element_size()


@pytest.mark.parametrize("multi", [False, True], ids=["16x16", "2x16x16"])
@pytest.mark.parametrize("arch", configs.ARCH_NAMES)
def test_param_bytes_follow_the_specs(census, arch, multi):
    axes = production_shape(multi).shape
    cfg = configs.get(arch)
    for shape in RULE_SHAPES:
        with sh.sharding_ctx(make_ctx(sh.MeshShape(axes), cfg,
                                      SHAPES[shape])):
            model = build_model(cfg, "meta")
            specs = tree_leaves(model.param_specs())
            leaves = tree_leaves(param_shapes(model))
        want = sum(_local_bytes(t.shape, t.dtype, s, axes)
                   for t, s in zip(leaves, specs))
        assert census[f"param/{arch}/{multi}/{shape}"] == want, shape


def test_per_device_rule_on_products(census):
    flops = 2 * B * S * D * F
    item = 4
    # x [B/16, S, D] @ w1 [D, F/16] → [B/16, S, F/16]: Shard on data and
    # model, so the global FLOPs over 256
    c = census["column"]
    assert c["flops"] == flops / 256
    assert c["bytes"] == item * (B // 16 * S * D + D * F // 16
                                 + B // 16 * S * F // 16)
    # h [B/16, S, F/16] @ w2 [F/16, D] → Partial over model: each rank
    # holds a whole-sized [B/16, S, D] partial sum
    c = census["row"]
    assert "Partial" in c["placements"]
    assert c["flops"] == flops / 256
    assert c["bytes"] == item * (B // 16 * S * F // 16 + F // 16 * D
                                 + B // 16 * S * D)
    # replicated: whole on every rank
    c = census["replicated"]
    assert c["flops"] == flops
    assert c["bytes"] == item * (B * S * D + D * F + B * S * F)
    # a manual region's plain product: as it is
    c = census["region"]
    assert c["flops"] == 2 * (B // 16) * S * D * (F // 16)


def test_decode_cell_flops_by_hand(census):
    """olmo-1b ``decode_32k`` on 16 × 16, one layer: the batch over data
    (8 a rank), the heads and the ff dim over model (1 head, 512 a rank),
    one token against the whole 32k cache."""
    cfg = configs.get("olmo-1b")
    shape = SHAPES["decode_32k"]
    b = shape.global_batch // 16
    h = cfg.n_heads // 16
    assert cfg.n_kv_heads == cfg.n_heads and cfg.mlp == "swiglu"
    qkvo = 2 * b * cfg.d_model * 4 * h * cfg.head_dim
    attn = 2 * 2 * b * h * shape.seq_len * cfg.head_dim
    mlp = 3 * 2 * b * cfg.d_model * cfg.d_ff // 16
    head = 2 * b * cfg.d_model * math.ceil(cfg.vocab / 16)
    assert census["olmo_1"]["flops"] == qkvo + attn + mlp + head
    assert census["olmo_full"]["flops"] == \
        cfg.n_layers * (qkvo + attn + mlp) + head


def test_two_point_fit_matches_direct_trace(census):
    from repro_torch.launch.dryrun import _fit
    fit = _fit(census["olmo_1"], census["olmo_2"], 1, 3)
    direct = census["olmo_3"]
    assert fit["flops"] == direct["flops"]
    assert fit["bytes_accessed"] == direct["bytes_accessed"]
    for k, v in direct["collectives"].items():
        assert fit["collectives"][k] == v, k
