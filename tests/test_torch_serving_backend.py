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
  before each dispatch.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.serving import backends as jb
from repro_torch import NotPortedError, configs
from repro_torch.convert import params_from_reference
from repro_torch.device import NoCudaDeviceError
from repro_torch.kernels.hermes_select import kernel as hk
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


def test_unported_balancers_and_default_device_raise():
    treg = tb.ModelRegistry()
    treg.register("olmo-1b", _cfgs("olmo-1b")[1])
    for name in ("HIKU", "DD", "SWARM", "JSQ2", "RR"):
        with pytest.raises(NotPortedError):
            tb.HermesFrontend(treg, balancer=name, device="cpu")
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
