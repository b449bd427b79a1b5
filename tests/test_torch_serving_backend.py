"""Port serving backend against the JAX package's ``repro.serving.backends``
on the smoke configs of the served models (dense: olmo-1b, musicgen-large;
recurrent: rwkv6-3b, zamba2-2.7b), on the CPU.

* ``Executor.run``: the same greedy tokens at ``dtype="float32"``, with
  the reference's parameters carried across; every step's logits within
  1e-4 (f32 across frameworks, another summation order).
* ``HermesFrontend``: the same (worker, cold) sequence as the reference's
  frontend over 6 requests alternating two models (the dense pair, or the
  recurrent pair), for ``H``, ``LL`` and ``LOC``, with the same
  background loads (one worker slot-full in turn) set on the workers
  before each dispatch; and for all nine balancers over 8 requests, with
  one deterministic clock in both modules so that the carried-state
  balancers learn the same measured durations, their final state equal
  to the reference's bit for bit.
"""
import dataclasses
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.serving import backends as jb
from repro_torch import configs
from repro_torch.convert import params_from_reference
from repro_torch.device import NoCudaDeviceError
from repro_torch.kernels.hermes_select import kernel as hk
from repro_torch.policy import balancer_names
from repro_torch.serving import backends as tb

SERVED = ("olmo-1b", "musicgen-large")
RECURRENT = ("rwkv6-3b", "zamba2-2.7b")
F32 = {"rtol": 1e-4, "atol": 1e-4}


def _cfgs(name, dtype="float32"):
    return tuple(dataclasses.replace(c.get_smoke(name), attn_impl="pallas",
                                     dtype=dtype)
                 for c in (jconfigs, configs))


def _registries(dtype="float32"):
    """A reference registry and a port registry that serve the same
    parameters (the reference's init at seeds 0 to 3)."""
    jreg, treg = jb.ModelRegistry(), tb.ModelRegistry()
    for seed, name in enumerate(SERVED + RECURRENT):
        jcfg, tcfg = _cfgs(name, dtype)
        jreg.register(name, jcfg, seed=seed)
        _, jparams = jreg.build(name)
        treg.register(name, tcfg, seed=seed, params=params_from_reference(
            tcfg, jax.tree.map(np.asarray, jparams), device="cpu"))
    return jreg, treg


@pytest.fixture(scope="module")
def registries():
    return _registries()


def _prompt(name, vocab, n=21, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, n)


@pytest.mark.parametrize("name", SERVED + RECURRENT)
def test_executor_matches_reference(name, registries):
    jreg, treg = registries
    jex = jb.Executor(jreg, name, max_len=48)
    tex = tb.Executor(treg, name, max_len=48, device="cpu")
    assert tex.cold_start_s > 0
    prompt = _prompt(name, tex.model.cfg.vocab)
    jinv = jb.Invocation(func=name, prompt=prompt, n_new=8)
    tinv = tb.Invocation(func=name, prompt=prompt, n_new=8)
    jtok = jex.run(jinv)
    ttok = tex.run(tinv)
    assert ttok.dtype == np.int32
    np.testing.assert_array_equal(ttok, jtok)
    assert tinv.prefill_s > 0 and tinv.decode_s > 0

    # every step's logits along the same greedy sequence
    jm, tm = jex.model, tex.model
    S = len(prompt)
    jc, tc = jm.init_cache(1, 48), tm.init_cache(1, 48)
    jl, jc = jex.prefill(jex.params, jnp.asarray(prompt, jnp.int32)[None],
                         jc)
    tl, tc = tm.prefill(tex.params, torch.from_numpy(prompt)[None], tc)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **F32)
    for i, tok in enumerate(jtok):
        t = np.array([[tok]])
        pos = np.array([S + i], np.int32)
        jl, jc = jex.decode(jex.params, jnp.asarray(t, jnp.int32), jc,
                            jnp.asarray(pos))
        tl, tc = tm.decode_step(tex.params, torch.from_numpy(t), tc,
                                torch.from_numpy(pos))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **F32)


def test_executor_refuses_prompt_past_max_len(registries):
    _, treg = registries
    tex = tb.Executor(treg, "olmo-1b", max_len=16, device="cpu")
    with pytest.raises(ValueError, match="max_len"):
        tex.run(tb.Invocation(func="olmo-1b", prompt=np.zeros(12, int),
                              n_new=5))


@pytest.mark.parametrize("balancer,models", [
    *(pytest.param(b, SERVED, id=b) for b in ("H", "LL", "LOC")),
    *(pytest.param(b, RECURRENT, id=f"{b}-recurrent")
      for b in ("H", "LL", "LOC"))])
def test_frontend_decisions_match_reference(balancer, models, registries,
                                            monkeypatch):
    """(worker, cold) of 6 alternating requests, with background loads
    drawn per dispatch and set on both frontends' workers.  The reference's
    executor is replaced by a stub (its decisions do not depend on the
    tokens); the port runs its models."""
    jreg, treg = registries

    class _StubExecutor:
        def __init__(self, registry, name, max_len):
            self.cold_start_s = 0.0

        def run(self, inv):
            return np.zeros(inv.n_new, np.int32)

    monkeypatch.setattr(jb, "Executor", _StubExecutor)
    jfe = jb.HermesFrontend(jreg, n_workers=3, cores=2, max_len=32,
                            balancer=balancer)
    tfe = tb.HermesFrontend(treg, n_workers=3, cores=2, max_len=32,
                            balancer=balancer, device="cpu")
    rng = np.random.default_rng(3)
    seq = []
    for i in range(6):
        name = models[i % 2]
        loads = rng.integers(0, 6, 3)
        loads[i % 3] = 16                       # one slot-full worker
        for fe in (jfe, tfe):
            for w, a in zip(fe.workers, loads):
                w.active = int(a)
        prompt = _prompt(name, 100, n=8, seed=i)
        j = jfe.dispatch(jb.Invocation(func=name, prompt=prompt, n_new=2))
        t = tfe.dispatch(tb.Invocation(func=name, prompt=prompt, n_new=2))
        assert (t.worker, t.cold) == (j.worker, j.cold), (i, loads)
        assert len(t.tokens) == 2 and t.response_s > 0
        seq.append((t.worker, t.cold))
    # the loads make the balancers place on more than one worker
    assert len({w for w, _ in seq}) > 1
    assert hk.hermes_select_batch.launches == 0      # CPU: plain version


class DispatchClock:
    """``time.perf_counter`` for both frontends: inside a ``dispatch`` it
    steps through ``times`` (one sequence per module, so that the two
    frontends read the same values); anywhere else it returns the last
    value read there (the port's executor reads the clock more often
    than the reference's stub does)."""

    def __init__(self, times):
        self.times = list(times)
        self.at = {}

    def __call__(self):
        frame = sys._getframe(1)
        mod = frame.f_globals.get("__name__")
        i = self.at.get(mod, 0)
        if frame.f_code.co_name == "dispatch":
            self.at[mod] = i + 1
            return self.times[i]
        return self.times[max(i - 1, 0)]


@pytest.mark.parametrize("balancer", balancer_names())
def test_frontend_zoo_decisions_match_reference(balancer, registries,
                                                monkeypatch):
    """(worker, cold) of 8 requests alternating olmo-1b and rwkv6-3b, with
    background loads set on both frontends' workers before each dispatch
    (one worker slot-full in turn, the rest drawn), and the durations the
    carried-state balancers learn from set by one clock: invocation i
    takes ``0.05 + 0.1 · (i mod 3)`` s.  Every balancer's choices equal
    the reference's, and HIKU's, DD's and SWARM's final state equals the
    reference's bit for bit."""
    jreg, treg = registries

    class _StubExecutor:
        def __init__(self, registry, name, max_len):
            self.cold_start_s = 0.0

        def run(self, inv):
            return np.zeros(inv.n_new, np.int32)

    monkeypatch.setattr(jb, "Executor", _StubExecutor)
    times = []
    for i in range(8):
        start = 10.0 * i
        times += [start, start + 0.05 + 0.1 * (i % 3)]
    monkeypatch.setattr(time, "perf_counter", DispatchClock(times))
    jfe = jb.HermesFrontend(jreg, n_workers=3, cores=2, max_len=32,
                            balancer=balancer)
    tfe = tb.HermesFrontend(treg, n_workers=3, cores=2, max_len=32,
                            balancer=balancer, device="cpu")
    rng = np.random.default_rng(5)
    seq = []
    for i in range(8):
        name = ("olmo-1b", "rwkv6-3b")[i % 2]
        loads = rng.integers(0, 5, 3)
        loads[i % 3] = 16                       # one slot-full worker
        for fe in (jfe, tfe):
            for w, a in zip(fe.workers, loads):
                w.active = int(a)
        prompt = _prompt(name, 100, n=6, seed=i)
        j = jfe.dispatch(jb.Invocation(func=name, prompt=prompt, n_new=2))
        t = tfe.dispatch(tb.Invocation(func=name, prompt=prompt, n_new=2))
        assert (t.worker, t.cold) == (j.worker, j.cold), (i, loads)
        seq.append(t.worker)
    assert (tfe._lb_state is None) == (jfe._lb_state is None)
    if jfe._lb_state is not None:
        assert set(tfe._lb_state) == set(jfe._lb_state)
        for key, want in jfe._lb_state.items():
            got = tfe._lb_state[key][0].numpy()
            want = np.asarray(want)
            assert got.dtype == want.dtype, key
            np.testing.assert_array_equal(got, want, err_msg=key)
    assert hk.hermes_select_batch.launches == 0      # CPU: plain version


def test_unported_balancers_and_default_device_raise():
    """The zoo's balancers, which the frontend once refused, build (their
    decisions: ``test_frontend_zoo_decisions_match_reference``); an unknown
    balancer and the default device without a card still raise."""
    treg = tb.ModelRegistry()
    treg.register("olmo-1b", _cfgs("olmo-1b")[1])
    for name in ("HIKU", "DD", "SWARM", "JSQ2", "RR"):
        fe = tb.HermesFrontend(treg, balancer=name, device="cpu")
        assert (fe._lb_state is not None) == (name in ("HIKU", "DD",
                                                       "SWARM"))
    with pytest.raises(ValueError, match="unknown load balancer"):
        tb.HermesFrontend(treg, balancer="NOPE", device="cpu")
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    with pytest.raises(NoCudaDeviceError):
        tb.HermesFrontend(treg)
    with pytest.raises(NoCudaDeviceError):
        tb.Executor(treg, "olmo-1b", max_len=16)
    from repro_torch.models.transformer import build_model
    with pytest.raises(NoCudaDeviceError):
        build_model(_cfgs("olmo-1b")[1])
