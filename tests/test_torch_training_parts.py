"""The port's training parts against the JAX package: the schedule and
AdamW, int8 quantization, the data generators, checkpoints and the
error-feedback sync.

Tolerances:

* ``schedule`` and ``adamw_update`` fed the same numpy parameters,
  gradients and moments: every leaf within 1e-6 relative to its max
  |value| (the same f32 operations; the global norm sums the same terms
  per layer where the reference sums them per stacked leaf, so the clip
  scale may differ in its last bit);
* ``quantize``, ``random_batch`` and ``lcg_batch``: bit for bit;
* ``ef_compress_sync`` on a two-process ``gloo`` group: bit for bit
  against a numpy model of its arithmetic, and within half the shared
  int8 step of the exact mean (the quantization bound).
"""
import json
import os
import socket
import subprocess
import sys
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.data import pipeline as jpipe
from repro.models import transformer as jtr
from repro.training import compression as jcomp
from repro.training import optimizer as jopt
from repro_torch import configs
from repro_torch.convert import params_from_reference, stack_like_reference
from repro_torch.data.pipeline import lcg_batch, make_data_iter, random_batch
from repro_torch.models.transformer import build_model
from repro_torch.training.checkpoint import CheckpointManager
from repro_torch.training.compression import dequantize, quantize
from repro_torch.training.optimizer import (OptCfg, OptState, adamw_update,
                                            decayed, init_opt_state,
                                            schedule)
from repro_torch.training.train import init_train_state

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OPT_TOL = 1e-6


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """Smoke-size ops run fastest on one thread, and the test workers
    share the host's cores (several threads each slowed a step ~5×)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _reference_without_x64():
    """Importing ``repro.core.simulator`` in the same worker turns JAX's
    x64 on; the reference's optimizer runs in f32 without it."""
    with jax.enable_x64(False):
        yield


# ---------------------------------------------------------------------------
# schedule and AdamW
# ---------------------------------------------------------------------------

def test_schedule_matches_reference():
    cfg = OptCfg(lr=1e-3, warmup_steps=10, total_steps=100)
    jcfg = jopt.OptCfg(lr=1e-3, warmup_steps=10, total_steps=100)
    got = np.array([float(schedule(cfg, torch.tensor(s, dtype=torch.int32)))
                    for s in range(101)], np.float32)
    want = np.array([float(jopt.schedule(jcfg, jnp.int32(s)))
                     for s in range(101)], np.float32)
    np.testing.assert_allclose(got, want, rtol=OPT_TOL, atol=0)


def test_schedule_shape():
    cfg = OptCfg(lr=1e-3, warmup_steps=10, total_steps=100)
    lrs = [float(schedule(cfg, s)) for s in range(0, 101, 10)]
    assert lrs[0] < lrs[1]                      # warmup
    assert max(lrs) <= 1e-3 * (1 + 1e-5)
    assert lrs[-1] == pytest.approx(1e-4, rel=1e-3)   # min_lr_frac


def test_adamw_decreases_quadratic():
    cfg = OptCfg(lr=0.1, warmup_steps=0, total_steps=100, weight_decay=0.0)
    params = {"w": torch.tensor([3.0, -2.0])}
    opt = init_opt_state(params)
    for _ in range(200):
        grads = {"w": 2 * params["w"]}
        params, opt, _ = adamw_update(cfg, params, grads, opt)
    assert float(params["w"].abs().max()) < 0.05


def _random_like(tree, rng, scale):
    return jax.tree.map(lambda a: (rng.standard_normal(a.shape) * scale
                                   ).astype(np.float32), tree)


@pytest.mark.parametrize("arch", ["olmo-1b", "qwen3-14b", "rwkv6-3b",
                                  "zamba2-2.7b"])
def test_adamw_update_matches_reference(arch):
    """One AdamW step at step 7 on the smoke config's parameters, with
    random gradients (clipped: their norm is far above 1) and moments."""
    jcfg = jconfigs.get_smoke(arch)
    tcfg = configs.get_smoke(arch)
    tree = jax.tree.map(np.asarray,
                        jtr.build_model(jcfg).init(jax.random.key(0)))
    rng = np.random.default_rng(11)
    grads = _random_like(tree, rng, 0.3)
    m = _random_like(tree, rng, 0.01)
    v = jax.tree.map(np.abs, _random_like(tree, rng, 1e-3))
    ocfg = OptCfg(lr=1e-2, warmup_steps=5, total_steps=100)
    jnew, jst, jmet = jopt.adamw_update(
        jopt.OptCfg(lr=1e-2, warmup_steps=5, total_steps=100),
        *(jax.tree.map(jnp.asarray, t) for t in (tree, grads)),
        jopt.OptState(jax.tree.map(jnp.asarray, m),
                      jax.tree.map(jnp.asarray, v), jnp.int32(7)))
    port = lambda t: params_from_reference(tcfg, t, "cpu")   # noqa: E731
    new, st, met = adamw_update(
        ocfg, port(tree), port(grads),
        OptState(port(m), port(v), torch.tensor(7, dtype=torch.int32)))
    assert int(st.step) == 8
    assert float(met["grad_norm"]) == pytest.approx(float(jmet["grad_norm"]),
                                                    rel=OPT_TOL)
    assert float(met["grad_norm"]) > 10          # the clip is active
    assert float(met["lr"]) == float(jmet["lr"])
    for got, want in ((new, jnew), (st.m, jst.m), (st.v, jst.v)):
        got = jax.tree.leaves(stack_like_reference(got))
        want = jax.tree.leaves(jax.tree.map(np.asarray, want))
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert a.shape == b.shape
            if b.size:
                err = np.abs(a.astype(np.float64) - b).max()
                assert err <= OPT_TOL * np.abs(b).max(), err


@pytest.mark.parametrize("arch", ["olmo-1b", "qwen3-14b", "rwkv6-3b",
                                  "zamba2-2.7b"])
def test_decay_falls_on_the_reference_leaves(arch):
    """The reference decays its leaves with ``ndim >= 2`` on the stacked
    layout: every per-layer vector (norm scales, mixes, biases: ``[L, D]``
    there) among them.  The port decays exactly those, by the rule and in
    effect (zero gradients and moments: only the decay moves a leaf)."""
    tcfg = configs.get_smoke(arch)
    jcfg = jconfigs.get_smoke(arch)
    tree = jax.tree.map(np.asarray,
                        jtr.build_model(jcfg).init(jax.random.key(0)))
    jflat = jax.tree_util.tree_flatten_with_path(tree)[0]
    want = {jax.tree_util.keystr(p) for p, a in jflat if a.ndim >= 2}
    params = build_model(tcfg, "cpu").init(torch.Generator().manual_seed(0))
    params = jax.tree.map(lambda t: t.abs() + 1.0, params)   # no zeros
    new, _, _ = adamw_update(OptCfg(lr=1e-2, warmup_steps=0),
                             params, jax.tree.map(torch.zeros_like, params),
                             init_opt_state(params))
    moved = jax.tree.map(lambda a, b: bool((a != b).any()),
                         stack_like_reference(new),
                         stack_like_reference(params))
    by_rule = {}
    for path, p in jax.tree_util.tree_flatten_with_path(params)[0]:
        keys = tuple(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path)
        stacked = ("layers",) + keys[2:] if keys[0] == "layers" else keys
        by_rule.setdefault(stacked, set()).add(decayed(keys, p))
    got_rule = {jax.tree_util.keystr(tuple(jax.tree_util.DictKey(k)
                                           for k in path))
                for path, v in by_rule.items() if v == {True}}
    got_moved = {jax.tree_util.keystr(p) for p, v in
                 jax.tree_util.tree_flatten_with_path(moved)[0] if v}
    assert all(len(v) == 1 for v in by_rule.values())
    assert got_rule == want
    assert got_moved == want
    trap = {"qwen3-14b": "ln1s", "rwkv6-3b": "ln1", "zamba2-2.7b": "ln"}
    if arch in trap:                     # a per-layer [D] norm scale
        assert f"['layers']['{trap[arch]}']" in want


# ---------------------------------------------------------------------------
# quantization
# ---------------------------------------------------------------------------

def _check_quantize(xs):
    x = np.asarray(xs, np.float32)
    q, scale = quantize(torch.from_numpy(x))
    jq, jscale = jcomp.quantize(jnp.asarray(x))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert np.float32(scale).view(np.uint32) == \
        np.float32(jscale).view(np.uint32)
    deq = dequantize(q, scale).numpy()
    np.testing.assert_array_equal(deq, np.asarray(jcomp.dequantize(jq,
                                                                   jscale)))
    assert np.abs(deq - x).max() <= float(scale) * 0.5 + 1e-6


@pytest.mark.parametrize("seed", range(20))
def test_quantize_matches_reference_seeded(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 65))
    _check_quantize(rng.uniform(-100, 100, n))


@pytest.mark.parametrize("xs", [[0.0], [100.0, -100.0], [1e-30] * 8,
                                [0.5, -0.5, 1.5, 2.5, -2.5, 127.0],
                                [3.0, 1.5, -0.75, 0.375]],
                         ids=["zero", "extremes", "tiny", "ties",
                              "halves"])
def test_quantize_matches_reference_corners(xs):
    """Corners, and ties: round half to even, as ``jnp.round``."""
    _check_quantize(xs)


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("step,batch,seq,vocab,seed", [
    (0, 4, 16, 97, 0), (7, 4, 16, 100, 0), (3, 8, 64, 50304, 1),
    (11, 2, 33, 512, 5)])
def test_batches_bit_equal(step, batch, seq, vocab, seed):
    for port, ref in ((random_batch, jpipe.random_batch),
                      (lcg_batch, jpipe.lcg_batch)):
        for a, b in zip(port(step, batch, seq, vocab, seed),
                        ref(step, batch, seq, vocab, seed)):
            assert a.dtype == b.dtype == np.int32
            np.testing.assert_array_equal(a, b)


def test_data_pipeline_deterministic():
    t1, l1 = random_batch(7, 4, 16, 100)
    t2, l2 = random_batch(7, 4, 16, 100)
    np.testing.assert_array_equal(t1, t2)
    t3, _ = random_batch(8, 4, 16, 100)
    assert not np.array_equal(t1, t3)
    t, l = lcg_batch(0, 4, 16, 97)
    np.testing.assert_array_equal(t[:, 1:], l[:, :-1])
    tokens, labels = make_data_iter("lcg", 4, 16, 97, device="cpu")(0)
    assert tokens.dtype == torch.int32 and tokens.device.type == "cpu"
    np.testing.assert_array_equal(tokens.numpy(), t)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def _leaves(state):
    return jax.tree.leaves(jax.tree.map(
        lambda t: t.view(torch.int16) if t.dtype == torch.bfloat16 else t,
        state))


@pytest.mark.parametrize("arch", ["musicgen-large", "dbrx-132b"])
def test_checkpoint_atomic_and_restores(arch):
    """The reference's test (musicgen-large, keep 2), and bf16 leaves
    (dbrx-132b's smoke config keeps bf16 parameters) by their bits."""
    model = build_model(configs.get_smoke(arch), "cpu")
    state = init_train_state(model, torch.Generator().manual_seed(0))
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d, keep=2)
        mgr.save(state, 10, blocking=True)
        mgr.save(state, 20, blocking=True)
        mgr.save(state, 30, blocking=True)
        assert mgr.latest_step() == 30
        # keep=2 garbage-collects the oldest
        assert not os.path.exists(os.path.join(d, "10"))
        assert sorted(os.listdir(d)) == ["20", "30"]
        # a crash mid-save leaves a <step>.tmp, which is not a checkpoint
        os.makedirs(os.path.join(d, "40.tmp"))
        assert mgr.latest_step() == 30
        restored, step = mgr.restore(state)
        assert step == 30
        for a, b in zip(_leaves(state), _leaves(restored)):
            assert a.dtype == b.dtype and a.device == b.device
            assert torch.equal(a, b)
        with open(os.path.join(d, "30", "manifest.json")) as f:
            manifest = json.load(f)
        assert manifest["step"] == 30
        first = "lm_head" if "lm_head" in state.params["embed"] else "tok"
        assert manifest["keys"][0] == f".params/embed/{first}"
        assert {".params/embed/tok", ".params/layers/0/attn/wq",
                ".opt/.m/embed/tok", ".opt/.step"} <= set(manifest["keys"])


def test_checkpoint_background_write_and_missing():
    model = build_model(configs.get_smoke("olmo-1b"), "cpu")
    state = init_train_state(model, torch.Generator().manual_seed(0))
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d)
        with pytest.raises(FileNotFoundError):
            mgr.restore(state)
        mgr.save(state, 5)
        mgr.wait()
        assert mgr.latest_step() == 5
        _, step = mgr.restore(state, step=5)
        assert step == 5


# ---------------------------------------------------------------------------
# error-feedback sync on a two-process gloo group
# ---------------------------------------------------------------------------

SHAPES = ((5, 7), (0,), (13,), (3, 2, 4))

_WORKER = r"""
import sys
import numpy as np
import torch
import torch.distributed as dist
from repro_torch.training.compression import ef_compress_sync, \
    init_error_feedback

rank, port, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
shapes = eval(sys.argv[4])
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        world_size=2, rank=rank)
rng = np.random.default_rng(100 + rank)
grads = {f"g{i}": torch.from_numpy(
    (rng.standard_normal(s) * (1 + 3 * rank)).astype(np.float32))
         for i, s in enumerate(shapes)}
err = init_error_feedback(grads)
res = {}
for it in range(2):
    synced, err = ef_compress_sync(grads, err)
    for k in grads:
        res[f"{it}/{k}/synced"] = synced[k].numpy()
        res[f"{it}/{k}/err"] = err[k].numpy()
for k, g in grads.items():
    res[f"grad/{k}"] = g.numpy()
np.savez(out, **res)
dist.destroy_process_group()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _numpy_sync(xs):
    """The sync's arithmetic in numpy on both members' ``g + err``."""
    scale = max(np.float32(max(np.abs(x).max(), np.float32(1e-12)))
                / np.float32(127.0) for x in xs)
    qs = [np.clip(np.rint(x / scale), -127, 127).astype(np.int8) for x in xs]
    errs = [x - q.astype(np.float32) * scale for x, q in zip(xs, qs)]
    total = sum(q.astype(np.int32) for q in qs)
    return total.astype(np.float32) * scale / np.float32(2), errs, scale


def test_ef_compress_sync_two_processes(tmp_path):
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1")
    outs = [tmp_path / f"rank{r}.npz" for r in range(2)]
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER, str(r), str(port), str(outs[r]),
         repr(SHAPES)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(2)]
    for p in procs:
        _, err = p.communicate(timeout=120)
        assert p.returncode == 0, err
    res = [np.load(o) for o in outs]
    grads = [{k: r[f"grad/g{k}"] for k in range(len(SHAPES))} for r in res]
    errs = [{k: np.zeros(s, np.float32) for k, s in enumerate(SHAPES)}
            for _ in range(2)]
    for it in range(2):
        for k, s in enumerate(SHAPES):
            got = [r[f"{it}/g{k}/synced"] for r in res]
            if not np.prod(s):
                assert all(g.shape == s for g in got)
                continue
            xs = [grads[r][k] + errs[r][k] for r in range(2)]
            want, new_errs, scale = _numpy_sync(xs)
            for r in range(2):
                np.testing.assert_array_equal(got[r], want)
                np.testing.assert_array_equal(res[r][f"{it}/g{k}/err"],
                                              new_errs[r])
                errs[r][k] = new_errs[r]
            exact = (xs[0] + xs[1]) / 2
            assert np.abs(want - exact).max() <= scale * 0.5 + 1e-6
