"""The port's training path against the JAX package on the smoke configs.

Parameters and train states come from the reference's own ``init`` and
are carried across with ``repro_torch.convert``; tokens are drawn with
numpy (the ``lcg`` batches are numpy on both sides).  Tolerances:

* gradients, f32: every leaf within 1e-4 × its max |value| (the port's
  f32 model bound: the same f32 math in another summation order across
  frameworks); the loss within 1e-5 relative;
* one step with ``microbatches=2``: the loss, grad norm and lr within
  1e-5 relative; the moments (the averaged, clipped gradient and its
  square) within the gradient bound; the new parameters within 1e-5 ×
  max |p| wherever the reference's first moment is at least 1e-2 × its
  leaf's max.  AdamW's first step moves a parameter by lr × g / (|g| +
  eps), so where g is near eps an f32 gap in g is an O(lr) gap in the
  parameter (measured: up to 3.6e-3 × max |p| there, at most 4.1e-7
  elsewhere);
* the 60-step f32 olmo-1b trajectory of the reference's
  ``test_train_loss_decreases``.  One port step from the reference's
  state at each step gives its loss within 1e-6 relative (measured: at
  most 1.7e-7).  The two free trajectories part slowly, as two f32 runs
  do: the gap grows from 1.5e-7 at step 0 to at most 1.14e-3 by step 60,
  and the reference run against itself from parameters perturbed by one
  ulp reaches 5.2e-4, so f32 rounding amplified by AdamW's sign-like
  first steps is the cause.  The bound is 2e-3 relative at every step.
"""
import dataclasses
import os
import subprocess
import sys
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import transformer as jtr
from repro.training import optimizer as jopt
from repro.training import train as jtrain
from repro_torch import configs
from repro_torch.convert import (params_from_reference, stack_like_reference,
                                 train_state_from_reference)
from repro_torch.data.pipeline import lcg_batch, make_data_iter
from repro_torch.models import transformer as tr
from repro_torch.training.checkpoint import CheckpointManager
from repro_torch.training.optimizer import OptCfg
from repro_torch.training.train import (build_train_step, init_train_state,
                                        run_with_restarts, value_and_grad)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MOMENT_FLOOR = 1e-2
GRAD_TOL = 1e-4
STEP_TOL = 1e-5
FORCED_TOL = 1e-6
TRAJ_TOL = 2e-3


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
    """The reference trains without x64: importing ``repro.core.simulator``
    in the same worker turns it on, and then the reference's microbatched
    step does not trace (``final_norm``'s ``jnp.zeros((0,))`` turns f64)."""
    with jax.enable_x64(False):
        yield


def _cfgs(name, **kw):
    kw = {"dtype": "float32", "param_dtype": "float32", **kw}
    return tuple(dataclasses.replace(c.get_smoke(name), **kw)
                 for c in (jconfigs, configs))


def _tokens(vocab, B=2, S=40, seed=3):
    t = np.random.default_rng(seed).integers(0, vocab, (B, S + 1),
                                             dtype=np.int32)
    return t[:, :-1], t[:, 1:]


def _grads(model, params, tokens, labels):
    """``(loss, grads)`` of the port's ``model.loss`` (unread leaves get
    zeros, as JAX gives them)."""
    loss, grads = value_and_grad(model.loss, params, torch.from_numpy(tokens),
                                 torch.from_numpy(labels))
    return float(loss), grads


def _leaf_close(got, want, tol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if want.size == 0:
        return
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= tol * scale, (what, err, scale)


def _trees_close(got, want, tol):
    gflat, gdef = jax.tree.flatten(got)
    wflat, wdef = jax.tree.flatten(want)
    assert gdef == wdef
    paths = [jax.tree_util.keystr(p)
             for p, _ in jax.tree_util.tree_flatten_with_path(want)[0]]
    for path, g, w in zip(paths, gflat, wflat):
        _leaf_close(g, w, tol, path)


def _reference_state(jcfg, seed=0):
    jmodel = jtr.build_model(jcfg)
    return jmodel, jtrain.init_train_state(jmodel, jax.random.key(seed))


# ---------------------------------------------------------------------------
# gradients of every family against jax.value_and_grad
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", configs.ARCH_NAMES)
def test_loss_and_grads_match_reference(arch):
    jcfg, tcfg = _cfgs(arch)
    jmodel = jtr.build_model(jcfg)
    tree = jax.tree.map(np.asarray, jmodel.init(jax.random.key(0)))
    tokens, labels = _tokens(tcfg.vocab)
    jloss, jgrads = jax.jit(jax.value_and_grad(jmodel.loss))(
        jax.tree.map(jnp.asarray, tree), jnp.asarray(tokens),
        jnp.asarray(labels))
    model = tr.build_model(tcfg, device="cpu")
    loss, grads = _grads(model, params_from_reference(tcfg, tree, "cpu"),
                         tokens, labels)
    assert loss == pytest.approx(float(jloss), rel=STEP_TOL)
    _trees_close(stack_like_reference(grads),
                 jax.tree.map(np.asarray, jgrads), GRAD_TOL)


@pytest.mark.parametrize("arch", configs.ARCH_NAMES)
def test_grads_equal_under_every_remat(arch):
    """Rematerialisation recomputes the same ops on the CPU: ``full`` and
    ``dots`` give ``none``'s gradients bit for bit."""
    tcfg = _cfgs(arch)[1]
    tokens, labels = _tokens(tcfg.vocab)
    params = tr.build_model(tcfg, "cpu").init(
        torch.Generator().manual_seed(1))
    out = {}
    for remat in ("none", "full", "dots"):
        model = tr.build_model(dataclasses.replace(tcfg, remat=remat), "cpu")
        out[remat] = _grads(model, params, tokens, labels)
    for remat in ("full", "dots"):
        assert out[remat][0] == out["none"][0]
        for a, b in zip(jax.tree.leaves(stack_like_reference(out[remat][1])),
                        jax.tree.leaves(stack_like_reference(out["none"][1]))):
            np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["olmo-1b", "rwkv6-3b", "zamba2-2.7b"])
def test_microbatched_step_matches_reference(arch):
    jcfg, tcfg = _cfgs(arch)
    ocfg = OptCfg(lr=1e-2, warmup_steps=2, total_steps=50)
    jmodel, jstate = _reference_state(jcfg)
    tokens, labels = lcg_batch(0, 4, 32, tcfg.vocab)
    jstep = jax.jit(jtrain.build_train_step(
        jmodel, jopt.OptCfg(**dataclasses.asdict(ocfg)), microbatches=2))
    jnew, jm = jstep(jstate, jnp.asarray(tokens), jnp.asarray(labels))
    state = train_state_from_reference(
        tcfg, jax.tree.map(np.asarray, jstate), device="cpu")
    step = build_train_step(tr.build_model(tcfg, "cpu"), ocfg,
                            microbatches=2)
    new, m = step(state, torch.from_numpy(tokens), torch.from_numpy(labels))
    for key in ("loss", "grad_norm", "lr"):
        assert float(m[key]) == pytest.approx(float(jm[key]), rel=STEP_TOL)
    assert int(new.opt.step) == int(jnew.opt.step) == 1
    for got, want in ((new.opt.m, jnew.opt.m), (new.opt.v, jnew.opt.v)):
        _trees_close(stack_like_reference(got),
                     jax.tree.map(np.asarray, want), GRAD_TOL)
    jm1 = jax.tree.leaves(jax.tree.map(np.asarray, jnew.opt.m))
    for got, want, m1 in zip(jax.tree.leaves(stack_like_reference(new.params)),
                             jax.tree.leaves(jax.tree.map(np.asarray,
                                                          jnew.params)), jm1):
        if m1.size:
            sel = np.abs(m1) >= MOMENT_FLOOR * np.abs(m1).max()
            err = np.abs(got - want)[sel].max()
            assert err <= STEP_TOL * np.abs(want).max(), (err, want.shape)


def test_train_trajectory_matches_reference():
    """The reference's ``test_train_loss_decreases`` (olmo-1b smoke, lcg
    4 × 32, lr 1e-2, warmup 5, total 100, 60 steps) in f32 on both sides
    from the same initial state.  At every step the port's step from the
    reference's state gives the reference's loss within ``FORCED_TOL``;
    the port's own trajectory stays within ``TRAJ_TOL`` of the
    reference's and meets its criterion (the last loss at least 0.5
    below the first)."""
    jcfg, tcfg = _cfgs("olmo-1b")
    ocfg = OptCfg(lr=1e-2, warmup_steps=5, total_steps=100)
    jmodel, jstate = _reference_state(jcfg)
    jstep = jax.jit(jtrain.build_train_step(
        jmodel, jopt.OptCfg(**dataclasses.asdict(ocfg))))
    state = train_state_from_reference(
        tcfg, jax.tree.map(np.asarray, jstate), device="cpu")
    step = build_train_step(tr.build_model(tcfg, "cpu"), ocfg)
    data = make_data_iter("lcg", 4, 32, tcfg.vocab, device="cpu")
    got, forced, want = [], [], []
    for i in range(60):
        tokens, labels = data(i)
        from_ref = train_state_from_reference(
            tcfg, jax.tree.map(np.asarray, jstate), device="cpu")
        forced.append(float(step(from_ref, tokens, labels)[1]["loss"]))
        state, m = step(state, tokens, labels)
        jstate, jm = jstep(jstate, jnp.asarray(tokens.numpy()),
                           jnp.asarray(labels.numpy()))
        got.append(float(m["loss"]))
        want.append(float(jm["loss"]))
    np.testing.assert_allclose(forced, want, rtol=FORCED_TOL)
    np.testing.assert_allclose(got, want, rtol=TRAJ_TOL)
    assert got[-1] < got[0] - 0.5, (got[0], got[-1])


# ---------------------------------------------------------------------------
# the fault-tolerant driver (ports of tests/test_training.py's)
# ---------------------------------------------------------------------------

def _smoke_olmo():
    cfg = configs.get_smoke("olmo-1b")
    return cfg, tr.build_model(cfg, "cpu")


def test_run_with_restarts_recovers_and_replays():
    cfg, model = _smoke_olmo()
    ocfg = OptCfg(lr=1e-2, warmup_steps=2, total_steps=50)
    data = make_data_iter("lcg", 4, 32, cfg.vocab, device="cpu")
    step = build_train_step(model, ocfg)

    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d)
        fails = {7, 18}

        def hook(s):
            if s in fails:
                fails.discard(s)
                raise RuntimeError("injected node failure")

        state = init_train_state(model, torch.Generator().manual_seed(0))
        state, rep = run_with_restarts(step, state, data, n_steps=25,
                                       ckpt_mgr=mgr, ckpt_every=5,
                                       failure_hook=hook)
        assert rep.steps_done == 25
        assert rep.restarts == 2
        # the replayed steps (5, 6 and 15-17) run twice
        assert len(rep.losses) == 25 + 2 + 3
        # identical run without failures reaches the same final loss
        state2 = init_train_state(model, torch.Generator().manual_seed(0))
        with tempfile.TemporaryDirectory() as d2:
            state2, rep2 = run_with_restarts(
                step, state2, data, n_steps=25,
                ckpt_mgr=CheckpointManager(d2), ckpt_every=5)
        assert rep.final_loss == pytest.approx(rep2.final_loss, rel=1e-5)
        assert rep.losses[5:7] == rep.losses[7:9] == rep2.losses[5:7]


def test_failure_before_first_checkpoint_replays_from_the_start():
    cfg, model = _smoke_olmo()
    step = build_train_step(model, OptCfg(lr=1e-2, warmup_steps=2,
                                          total_steps=50))
    data = make_data_iter("lcg", 2, 16, cfg.vocab, device="cpu")
    state = init_train_state(model, torch.Generator().manual_seed(0))
    fails = {3}

    def hook(s):
        if s in fails:
            fails.discard(s)
            raise RuntimeError("injected node failure")

    with tempfile.TemporaryDirectory() as d:
        _, rep = run_with_restarts(step, state, data, n_steps=6,
                                   ckpt_mgr=CheckpointManager(d),
                                   ckpt_every=5, failure_hook=hook)
    assert rep.restarts == 1 and rep.steps_done == 6
    assert rep.losses[:3] == rep.losses[3:6]     # the state was not mutated


def test_restart_budget_exhaustion_raises():
    cfg, model = _smoke_olmo()
    step = build_train_step(model, OptCfg(lr=1e-3, warmup_steps=2,
                                          total_steps=50))
    data = make_data_iter("lcg", 2, 16, cfg.vocab, device="cpu")
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d)
        state = init_train_state(model, torch.Generator().manual_seed(0))
        calls = []

        def hook(s):
            calls.append(s)
            raise RuntimeError("always failing")

        with pytest.raises(RuntimeError, match="always failing"):
            run_with_restarts(step, state, data, n_steps=10, ckpt_mgr=mgr,
                              max_restarts=2, failure_hook=hook)
        assert len(calls) == 3


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def _launch(*flags):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                           *flags], env=env, cwd=REPO, capture_output=True,
                          text=True, timeout=120)


def test_launcher_trains_on_the_cpu(tmp_path):
    ckpt = tmp_path / "ckpt"
    out = _launch("--smoke", "--device", "cpu", "--arch", "olmo-1b",
                  "--steps", "30", "--lr", "1e-2", "--batch", "4", "--seq",
                  "32", "--ckpt-every", "10", "--ckpt-dir", str(ckpt))
    assert out.returncode == 0, out.stderr
    line = out.stdout.strip().splitlines()[-1]
    head, rest = line.split(" steps in ")
    assert head == "30" and rest.endswith("; restarts=0"), line
    first, last = (float(x) for x in
                   rest.split("; loss ")[1].split(";")[0].split(" → "))
    assert last < first - 0.5, line
    assert sorted(os.listdir(ckpt)) == ["10", "20", "30"]


#: the named error each refusal raises in a one-process world: the
#: production meshes need 256 and 512 ranks, the compressed step a
#: multi-pod mesh
REFUSALS = {("--mesh", "single"): "MeshSizeError: a 16 x 16 mesh",
            ("--mesh", "multi"): "MeshSizeError: a 2 x 16 x 16 mesh",
            ("--compress-pods",): "CompressedStepError"}


@pytest.mark.parametrize("flags", [("--mesh", "single"), ("--mesh", "multi"),
                                   ("--compress-pods",)])
def test_launcher_refuses_meshes(flags, tmp_path):
    out = _launch("--smoke", "--device", "cpu", *flags, "--ckpt-dir",
                  str(tmp_path / "ckpt"))
    assert out.returncode != 0
    assert REFUSALS[flags] in out.stderr, out.stderr[-2000:]
    assert "steps in" not in out.stdout           # stopped before any step
