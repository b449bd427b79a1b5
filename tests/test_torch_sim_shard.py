"""The replication split of the streaming simulator on the CPU
(``repro_torch.launch.mesh.make_rep_mesh``,
``repro_torch.distribution.sim_shard.shard_reps``, ``simulate_stream(mesh=
...)``).

A two-device ``"cpu"`` mesh: the split stream equals the unsplit one bit
for bit (final state, per-arrival planes, sketches, counters) for E/LL/PS,
the full DD + HYBRID_HIST + ``two-gen`` + ``TARGET_P99`` stack and
E/LL/SRPT; ``shard_reps`` cuts every leaf into contiguous shards; a rep
count the mesh does not divide and a mesh without the ``"rep"`` axis raise
the reference's named errors (the latter held to the reference's own
message where JAX is installed); ``make_rep_mesh`` refuses an empty mesh
and, without a card, the default one.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import (E_DD_PS, E_LL_PS, ClusterCfg, FleetCfg,
                              LifecycleCfg, parse_policy, stack_workloads,
                              synth_workload)
from repro_torch.core.streaming import final_states_equal, simulate_stream
from repro_torch.device import NoCudaDeviceError
from repro_torch.distribution.sim_shard import shard_reps
from repro_torch.launch.mesh import REP_AXIS, RepMesh, make_rep_mesh

try:
    import jax

    from repro.distribution.sim_shard import shard_reps as jax_shard_reps
except ImportError:     # no JAX installed: the reference test skips
    jax = None

EQ = ClusterCfg(n_workers=4, cores=3, capacity_factor=2)
FULL = EQ._replace(
    lifecycle=LifecycleCfg(keepalive="HYBRID_HIST", ttl_s=2.0, max_idle=3,
                           coldstart="paper-sim"),
    fleet=FleetCfg(preset="two-gen", autoscale="TARGET_P99", min_workers=2,
                   target_p99=4.0, cooldown_s=2.0))
STACKS = {"E/LL/PS": (E_LL_PS, EQ),
          "E/DD/PS|ka=HYBRID_HIST|fleet|auto": (E_DD_PS, FULL),
          "E/LL/SRPT": (parse_policy("E/LL/SRPT"), EQ)}
LOADS = ((0.6, 0), (1.0, 1), (0.8, 2), (0.9, 3))


def _batch(cluster, n=160):
    return stack_workloads(synth_workload(cluster, load, n, n_functions=5,
                                          seed=seed) for load, seed in LOADS)


def test_make_rep_mesh():
    mesh = make_rep_mesh(devices=("cpu", "cpu"))
    assert isinstance(mesh, RepMesh) and isinstance(mesh, tuple)
    assert mesh.axis_names == (REP_AXIS,) and mesh.shape == {REP_AXIS: 2}
    assert mesh.devices == (torch.device("cpu"),) * 2
    assert len(make_rep_mesh(1, devices=("cpu", "cpu"))) == 1
    with pytest.raises(ValueError, match="n_devices must be >= 1, got 0"):
        make_rep_mesh(0, devices=("cpu",))
    with pytest.raises(ValueError, match="exceeds"):
        make_rep_mesh(3, devices=("cpu", "cpu"))
    if not torch.cuda.is_available():
        with pytest.raises(NoCudaDeviceError):
            make_rep_mesh()
    else:
        assert len(make_rep_mesh()) == torch.cuda.device_count()


def test_shard_reps_cuts_contiguous_shards():
    mesh = make_rep_mesh(devices=("cpu", "cpu"))
    x = np.arange(12, dtype=np.float64).reshape(4, 3)
    tree = {"x": x, "y": (torch.arange(4), torch.tensor(7))}
    parts = shard_reps(tree, mesh)
    assert len(parts) == 2
    for i, part in enumerate(parts):
        assert torch.equal(part["x"], torch.as_tensor(x[2 * i:2 * i + 2]))
        assert torch.equal(part["y"][0], torch.arange(2 * i, 2 * i + 2))
        assert int(part["y"][1]) == 7          # 0-d: copied whole
        assert isinstance(part["y"], tuple)


def test_named_errors():
    mesh = make_rep_mesh(devices=("cpu", "cpu"))
    with pytest.raises(ValueError, match="replication axis of size 3 does "
                                         "not divide across the 2-device"):
        shard_reps({"x": np.zeros((3, 2))}, mesh)
    with pytest.raises(ValueError, match="expected a 1-D 'rep' mesh"):
        shard_reps({"x": np.zeros((4, 2))}, ("cpu", "cpu"))
    with pytest.raises(ValueError, match="does not divide"):
        simulate_stream(E_LL_PS, EQ, _batch(EQ, 40)[:3], chunk_size=16,
                        mesh=mesh)
    with pytest.raises(ValueError, match="expected a 1-D 'rep' mesh"):
        simulate_stream(E_LL_PS, EQ, _batch(EQ, 40), chunk_size=16,
                        mesh=(torch.device("cpu"),))


def test_not_a_rep_mesh_matches_the_reference():
    if jax is None:
        pytest.skip("the JAX reference package is not installed here")
    other = jax.make_mesh((1,), ("data",))
    with pytest.raises(ValueError) as want:
        jax_shard_reps({"x": np.zeros((2, 2))}, other)

    class DataMesh(tuple):
        axis_names = ("data",)

    with pytest.raises(ValueError) as got:
        shard_reps({"x": np.zeros((2, 2))}, DataMesh(("cpu",)))
    assert str(got.value).replace("repro_torch.", "repro.") == \
        str(want.value)


@pytest.mark.parametrize("stack", STACKS)
def test_split_stream_equals_the_unsplit_one(stack):
    policy, cluster = STACKS[stack]
    wb = _batch(cluster)
    mesh = make_rep_mesh(devices=("cpu", "cpu"))
    whole = simulate_stream(policy, cluster, wb, chunk_size=50, device="cpu",
                            collect_outputs=True, keep_final_state=True)
    split = simulate_stream(policy, cluster, wb, chunk_size=50, mesh=mesh,
                            collect_outputs=True, keep_final_state=True)
    ok, bad = final_states_equal(split.final_state, whole.final_state)
    assert ok, bad
    for k in whole.final_state:
        assert torch.equal(split.final_state[k], whole.final_state[k]), k
    for f in ("cold", "rejected", "worker", "n_done", "n_observed",
              "resp_mean", "slow_mean", "server_time", "prov_core_s"):
        assert getattr(split, f).tobytes() == getattr(whole, f).tobytes(), f
    assert split.telemetry.slow_hist.tobytes() == \
        whole.telemetry.slow_hist.tobytes()
    assert split.n_reps == 4
    # a chunk callback sees the whole carry, put back together
    seen = []
    simulate_stream(policy, cluster, wb, chunk_size=80, mesh=mesh,
                    chunk_callback=lambda c, st: seen.append(
                        int(st["stream_n_done"].shape[0])))
    assert seen == [4, 4]
