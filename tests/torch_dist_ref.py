"""The reference's side of the port's multi-rank tests: its weights and
single-device train steps, run in the test process (JAX on the CPU,
``jax.enable_x64(False)``, as another test file in the same worker may
have turned x64 on)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from repro import configs as jconfigs
from repro.models import transformer as jtr
from repro.training import optimizer as jopt
from repro.training import train as jtrain
from repro_torch import configs
from repro_torch.convert import params_from_reference
from repro_torch.training.tree import flatten_with_paths


def f32(name, jax_side=False):
    mod = jconfigs if jax_side else configs
    return dataclasses.replace(mod.get_smoke(name), dtype="float32")


def ref_params(name, jit=False, **kw):
    """The reference's init (key 0) of ``name``'s f32 smoke config, run
    eagerly or, with ``jit``, compiled (faster; other values from the same
    key): (its tree, the port's tree, the worker's arrays; a bf16 leaf
    crosses as f32, which holds it exactly)."""
    jcfg = dataclasses.replace(f32(name, True), **kw)
    with jax.enable_x64(False):
        init = jtr.build_model(jcfg).init
        jp = (jax.jit(init) if jit else init)(jax.random.key(0))
    tp = params_from_reference(dataclasses.replace(f32(name), **kw), jp,
                               "cpu")
    return jp, tp, {"p/" + "/".join(path): leaf.float().numpy()
                    for path, leaf in flatten_with_paths(tp)}


def ref_steps(name, ocfg, jp, tokens, labels, n):
    """``n`` of the reference's single-device train steps: (losses, the
    final parameters as the port's tree of numpy arrays)."""
    jcfg = f32(name, True)
    with jax.enable_x64(False):
        model = jtr.build_model(jcfg)
        state = jtrain.init_train_state(model, jax.random.key(0))
        state = state._replace(params=jp)
        step = jax.jit(jtrain.build_train_step(model, jopt.OptCfg(
            **dataclasses.asdict(ocfg))))
        losses = []
        for _ in range(n):
            state, m = step(state, jnp.asarray(tokens), jnp.asarray(labels))
            losses.append(float(m["loss"]))
        params = jax.tree.map(np.asarray, state.params)
    return losses, params_from_reference(f32(name), params, "cpu")


def leaves(out, prefix, like):
    return [out[prefix + "/".join(p)] for p, _ in flatten_with_paths(like)]
