"""The port's sharded forward of the recurrent families (``rwkv6``,
``hybrid``) on real multi-rank ``gloo`` groups on the CPU, against the
reference's single-device runs from the same weights
(``repro_torch.convert.params_from_reference``; the JAX side runs as
``tests/test_torch_recurrent_models.py`` runs it, ``attn_impl="pallas"``,
with x64 off).

* rwkv6-3b's and zamba2-2.7b's smoke configs on (1, 2) and (2, 2)
  ``data × model`` meshes, parameters and caches laid out by their specs:
  the full forward, a prefill and teacher-forced decode steps.  The scans
  run in manual regions on each rank's local heads and see plain tensors
  only.  f32: the logits and every cache tensor within 1e-4 × its max
  |value|.  bf16: within 6e-2 × max |value|, and the RMS gap to the
  reference's f32 within 1.5× the reference's own bf16's (ROADMAP Queue
  3's watch: the sharded scans must not widen it);
* rwkv6's smoke config on (1, 4): its 2 heads do not divide the ``model``
  axis, so every rank runs both, and the carried state is not split.

The sharded gradients and AdamW step are held in
``tests/test_torch_distributed_recurrent_train.py``.  One world of 4
ranks runs the (2, 2) and (1, 4) meshes, one of 2 the (1, 2) mesh
(``tests/torch_dist_worker.py``; the rendezvous and every collective time
out after 90 s, a world after 150 s); both start at once, and the
reference runs here meanwhile.
"""
import dataclasses
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro import configs as jconfigs
from repro.models import transformer as jtr
from torch_dist_ref import ref_params
from torch_dist_worker import Ranks

RECURRENT = ("rwkv6-3b", "zamba2-2.7b")
DTYPES = ("float32", "bfloat16")
MESHES = {(1, 2): RECURRENT, (2, 2): RECURRENT, (1, 4): ("rwkv6-3b",)}
#: batch, prompt and decode steps (the prompt is ragged against both
#: smoke chunks, 8 and 16)
B, S, STEPS = 2, 29, 2
TOL = {"float32": 1e-4, "bfloat16": 6e-2}
RMS_RATIO = 1.5
#: the scans' heads a rank: rwkv6's 2 WKV heads, zamba2's 8 SSD heads
HEADS = {"rwkv6-3b": ("wkv6", 2), "zamba2-2.7b": ("ssd", 8)}


def _reference(arch, dtype, jp, toks):
    """The reference's forward logits, the logits of a prefill of ``S``
    tokens and of each teacher-forced decode step, and the final cache,
    as f32 numpy arrays."""
    jcfg = dataclasses.replace(jconfigs.get_smoke(arch), dtype=dtype,
                               attn_impl="pallas")
    model = jtr.build_model(jcfg)
    n = toks.shape[1]
    with jax.enable_x64(False):
        out = {"forward": jax.jit(model.forward)(jp, jnp.asarray(toks))[0]}
        cache = model.init_cache(B, n)
        lg, cache = jax.jit(model.prefill)(jp, jnp.asarray(toks[:, :S]),
                                           cache)
        served = [lg]
        decode = jax.jit(model.decode_step)
        for i in range(S, n):
            lg, cache = decode(jp, jnp.asarray(toks[:, i:i + 1]), cache,
                               jnp.full((B,), i, jnp.int32))
            served.append(lg)
        out["served"] = jnp.concatenate(served, axis=1)
        out.update({"cache/" + k: v for k, v in cache.items()})
        return {k: np.asarray(v, np.float32) for k, v in out.items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """``(ranks' outputs by mesh, the reference's outputs by (arch,
    dtype))``: every group of ranks started at once, the reference run
    while they work (its compiles in threads, each with x64 off)."""
    toks = np.random.default_rng(13).integers(0, 512, (B, S + STEPS))
    inp, jps = {}, {}
    with ThreadPoolExecutor(len(RECURRENT)) as pool:
        for arch, (jp, _, p) in zip(RECURRENT, pool.map(
                lambda a: ref_params(a, jit=True), RECURRENT)):
            jps[arch] = jp
            inp.update({f"p.{arch}/" + k[2:]: v for k, v in p.items()})
    # the (2, 2) and (1, 4) meshes on one world of 4, the (1, 2) mesh on
    # a world of 2
    groups = {4: [(2, 2), (1, 4)], 2: [(1, 2)]}
    ranks = {world: Ranks("recurrent", world, dict(
        inp, toks=toks, S=np.int64(S), meshes=np.array(meshes),
        mesh_archs=np.array([",".join(MESHES[m]) for m in meshes]),
        dtypes=np.array(DTYPES)), tmp_path_factory.mktemp(f"world{world}"))
        for world, meshes in groups.items()}
    combos = [(arch, dtype) for arch in RECURRENT for dtype in DTYPES]
    with ThreadPoolExecutor(len(combos)) as pool:
        ref = dict(zip(combos, pool.map(
            lambda c: _reference(*c, jps[c[0]], toks), combos)))
    outs = {world: r.wait() for world, r in ranks.items()}
    return {m: outs[world] for world, meshes in groups.items()
            for m in meshes}, ref


CASES = [(mesh, arch, dtype) for mesh, archs in MESHES.items()
         for arch in archs for dtype in DTYPES]


@pytest.mark.parametrize("mesh,arch,dtype", CASES,
                         ids=["x".join(map(str, m)) + f"-{a}-{d}"
                              for m, a, d in CASES])
def test_sharded_recurrent_matches_reference(runs, mesh, arch, dtype,
                                             capsys):
    outs, ref = runs
    want = ref[arch, dtype]
    tag = "x".join(map(str, mesh)) + "/"
    key = f"{tag}{arch}/{dtype}/"
    scan, n_heads = HEADS[arch]
    split = n_heads % mesh[1] == 0
    r0 = outs[mesh][0]
    state = "wkv" if arch == "rwkv6-3b" else "ssm"
    spec = {s.split(": ")[0]: s.split(": ")[1]
            for s in r0[key + "cache_specs"]}
    # the carried state's heads over model where they divide it
    assert spec[state] == ("Spec(None, ('data',), 'model', None, None)"
                           if split else
                           "Spec(None, ('data',), None, None, None)")
    # the scan saw plain tensors of the rank's local heads only
    local = n_heads // mesh[1] if split else n_heads
    for r in outs[mesh]:
        assert [tuple(c) for c in r[f"{tag}scan/{scan}"]] == [(local, 0)]
        for name in want:
            np.testing.assert_array_equal(r[key + name], r0[key + name])
    for name, w in want.items():
        got = r0[key + name]
        assert got.shape == w.shape, name
        gap = float(np.abs(got - w).max())
        assert gap <= TOL[dtype] * float(np.abs(w).max()), (name, gap)
    if dtype == "bfloat16":
        truth = ref[arch, "float32"]
        for name, w in truth.items():
            rms = [float(np.sqrt(np.mean(np.square(g - w))))
                   for g in (r0[key + name], want[name])]
            with capsys.disabled():
                print(f"{arch} on {mesh}: {name} |bf16 - reference f32| RMS "
                      f"sharded {rms[0]:.5f}, reference {rms[1]:.5f}")
            assert rms[0] <= RMS_RATIO * rms[1], (name, rms)

