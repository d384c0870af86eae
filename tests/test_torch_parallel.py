"""The port's multi-rank paths (reinmav_tpu_torch.parallel and the sharded
learners) on the CPU: two gloo ranks in processes of their own
(tests/_torch_parallel_worker.py), held against the JAX package and
against the port's own one-rank runs.

(a) ``distributed.init``'s contract, as tests/test_multiprocess.py holds
the JAX one: explicit misconfiguration raises, auto-detect off a cluster
is a no-op, a conflicting second call raises.
(b) The shard_map PPO update: JAX's ``train_step(axis_name=...)`` under
shard_map on a 2-device sub-mesh of the 8 virtual CPU devices; each
rank's rollout is JAX's ``collect_rollout`` with the same ``fold_in`` of
the device index, the permutations those of ``fold_in(key, 0x9E3779B9)``
(tests/test_torch_ppo.py's ``_perms_from_jax_keys``).  The port's two
ranks run ``update_phase`` under shard_map on them, through K3's twin and
through autograd: params, Adam moments, normalisers and metrics at
tests/test_torch_ppo.py's tolerance, the two ranks' params bitwise equal.
(c) The mesh mode: two ranks equal the one-rank run at the same global
batch, in float64 (eager rollout, autograd) and in float32 (the K2 and K4
twins); the sharded control rollout without resets equals the one-rank
rollout to 1e-12 (tests/test_sharding.py:25-45); sharded_dense_rollout
equals JAX's on 2 devices where no env resets, is deterministic per seed
and folds the rank into its reset stream (tests/test_sharding.py:94-111);
shard_batch, batch_sharding, replicated and the distributed batch helpers.
(d) SAC and TD3: a two-rank ``update_step``, each rank on its own batch,
equals the one-rank step on the two batches concatenated at rtol 1e-10
(the losses are means over equal batches, so the averaged gradient is the
union's); after 8 two-rank iterations the replicas are bitwise equal.
(e) The collective checkpoint: a fresh group's resume is bitwise the
uninterrupted run; another world size is refused by name.
"""

import functools
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh
from jax.sharding import PartitionSpec as P

import reinmav_tpu_torch
from _torch_parallel_worker import (CKPT_PPO, DENSE_B, DENSE_T, MESH_CFG, MESH_STEPS,
                                    MESH_TWIN_CFG, OFF_BATCH, ROLLOUT_BATCH, ROLLOUT_T, SAC_CFG,
                                    SHARDMAP_CFG, TD3_CFG, mesh_states, off_nets, off_update,
                                    off_update_inputs)
import reinmav_tpu
from reinmav_tpu.envs.core import control_rollout as jcontrol_rollout
from reinmav_tpu.parallel import mesh as jmesh
from reinmav_tpu.rl import ppo as jppo
from reinmav_tpu_torch.parallel import Mesh, make_mesh, shard_state
from reinmav_tpu_torch.rl import networks, ppo, sac, td3
from reinmav_tpu_torch.utils import checkpoint as ckpt
from test_torch_ppo import RTOL, ATOL, _jax_state, _perms_from_jax_keys, _port_state

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_WORKER = os.path.join(_REPO, "tests", "_torch_parallel_worker.py")
_AXIS = "env_batch"
CPU1 = Mesh(None, 1, 0, torch.device("cpu"))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _env():
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "LOCAL_RANK",
                        "LOCAL_WORLD_SIZE")}
    env["OMP_NUM_THREADS"] = "1"
    return env


def _run_ranks(out_dir: str, phase: str, world: int = 2, timeout: int = 240) -> None:
    port = _free_port()
    procs = [subprocess.Popen([sys.executable, _WORKER, str(port), str(world), str(r), out_dir,
                               phase], env=_env(), cwd=_REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(world)]
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=timeout)[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} ({phase}) failed:\n{out[-4000:]}"


def _jax_shardmap(out_dir: str):
    """JAX's shard_map update on 2 devices, and the inputs the port's ranks
    need for the same update, written to ``ppo_shardmap.npz``."""
    jcfg = jppo.PpoConfig(**SHARDMAP_CFG)
    env, jstate = _jax_state(jcfg)
    mesh = JaxMesh(np.asarray(jax.devices()[:2]), (_AXIS,))
    bs, rep = P(_AXIS), P()
    specs = jppo.TrainState(params=rep, opt_state=rep, env_states=bs,
                            obs_norm=jppo.ObsNorm(rep, rep, rep), ret_norm=jppo.RetNorm(rep, rep),
                            env_returns=bs, key=rep, update_step=rep, kl_beta=rep)
    shard_map = jppo._shard_map_fn()
    step = shard_map(functools.partial(jppo.train_step, env, jcfg, dense8=False,
                                       fused_rollout=False, fused_loss=False, axis_name=_AXIS),
                     mesh=mesh, in_specs=(specs,), out_specs=(specs, rep), check_vma=False)
    s_ref, m_ref = jax.jit(step)(jstate)

    def local(s):
        k = jax.random.fold_in(s.key, jax.lax.axis_index(_AXIS))
        final, rets, _, traj, om, rm, raw = jppo.collect_rollout(
            env, jcfg, s.params, s.obs_norm, s.ret_norm, s.env_states, s.env_returns, k,
            dense8=False)
        return final, rets, traj, jax.tree.map(lambda x: x[None], (om, rm, raw))

    cols = P(None, _AXIS)
    traj_spec = jppo.Transition(P(None, None, _AXIS), P(None, None, _AXIS), cols, cols, cols,
                                cols)
    roll = shard_map(local, mesh=mesh, in_specs=(specs,), out_specs=(bs, bs, traj_spec, bs),
                     check_vma=False)
    final, rets, traj, (om, rm, raw) = jax.jit(roll)(jstate)

    pstate = _port_state(jstate, jcfg)
    b = jcfg.num_envs // 2
    _, n_tiles = ppo._tiling(ppo.PpoConfig(**SHARDMAP_CFG), jcfg.rollout_len * b)
    perm_key = jax.random.fold_in(jstate.key, jnp.uint32(0x9E3779B9))
    f32 = lambda x: np.asarray(x, np.float32)  # noqa: E731
    arrays = {"params": pstate.params.numpy(), "count": pstate.opt_state.count.numpy(),
              "mu": pstate.opt_state.mu.numpy(), "nu": pstate.opt_state.nu.numpy(),
              "obs_mean": pstate.obs_norm.mean.numpy(), "obs_var": pstate.obs_norm.var.numpy(),
              "obs_count": pstate.obs_norm.count.numpy(), "ret_var": pstate.ret_norm.var.numpy(),
              "ret_count": pstate.ret_norm.count.numpy(), "kl_beta": pstate.kl_beta.numpy(),
              "perms": torch.stack(_perms_from_jax_keys(perm_key, n_tiles,
                                                        jcfg.num_epochs)).numpy()}
    for r in range(2):
        cut = slice(r * b, (r + 1) * b)
        arrays[f"final_{r}"], arrays[f"rets_{r}"] = f32(final)[cut], f32(rets)[cut]
        arrays[f"raw_{r}"] = f32(raw)[r]
        for name, x in zip(ppo.Transition._fields, traj):
            x = np.asarray(x)
            arrays[f"traj_{name}_{r}"] = (x if x.dtype == np.bool_ else f32(x))[..., cut]
        for i in range(3):
            arrays[f"omom_{i}_{r}"], arrays[f"rmom_{i}_{r}"] = f32(om[i])[r], f32(rm[i])[r]
    np.savez(os.path.join(out_dir, "ppo_shardmap.npz"), **arrays)
    return s_ref, m_ref


def _jax_dense(out_dir: str) -> None:
    """JAX's sharded_dense_rollout on a 2-device sub-mesh from DENSE_B
    reset states, and states far outside the envelope (every env resets
    on its first step) for the ranks' stream check, written to ``dense.npz``.
    JAX's loop has no reset in DENSE_T steps from those states, so its
    result does not depend on the reset streams, which differ by design."""
    env = reinmav_tpu.make("quadrotor3d-v0")
    key = jax.random.PRNGKey(0)
    states = np.asarray(env.vreset(jax.random.split(key, DENSE_B)), np.float64)
    mesh = JaxMesh(np.asarray(jax.devices()[:2]), (_AXIS,))
    placed = jax.device_put(jnp.asarray(states), jmesh.batch_sharding(mesh))
    final, rewards = jmesh.sharded_dense_rollout(env, mesh, placed, key, DENSE_T)
    _, traj = jcontrol_rollout(env, jnp.asarray(states), key, DENSE_T, auto_reset=False)
    far = states[:8].copy()
    far[:, :3] *= 100.0
    np.savez(os.path.join(out_dir, "dense.npz"), states=states, far=far,
             jax_final=np.asarray(final), jax_rewards=np.asarray(rewards),
             jax_dones=int(np.asarray(traj.done).sum()))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX side, then the two ranks' main phase and their restore in a
    fresh group; returns ``(the outputs' directory, JAX's state and
    metrics)``."""
    out_dir = str(tmp_path_factory.mktemp("parallel"))
    ref = _jax_shardmap(out_dir)
    _jax_dense(out_dir)
    _run_ranks(out_dir, "main")
    _run_ranks(out_dir, "restore")
    return out_dir, ref


def _load(out_dir: str, name: str):
    return [torch.load(os.path.join(out_dir, f"{name}_rank{r}.pt"), weights_only=False)
            for r in range(2)]


def _bitwise(a, b, what: str) -> None:
    """Two trees of tensors bit for bit."""
    if isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b), what
    elif isinstance(a, tuple):
        for i, (x, y) in enumerate(zip(a, b)):
            _bitwise(x, y, f"{what}[{i}]")
    else:
        assert a == b, what


def _close(got, ref, what, rtol=RTOL, atol=ATOL) -> None:
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(ref, np.float64),
                               rtol=rtol, atol=atol, err_msg=what)


# (a) ----------------------------------------------------------------------

_INIT_PROBE = r"""
import os, sys
sys.path.insert(0, %r)
from reinmav_tpu_torch.parallel import distributed
try:
    distributed.init(coordinator_address="localhost:1", num_processes=2, process_id=5,
                     device="cpu")
except Exception as e:
    print("EXPLICIT RAISED", type(e).__name__)
else:
    print("EXPLICIT SILENT")
distributed.init(device="cpu")
print("AUTODETECT", distributed.world_size(), distributed.device())
os.environ.update(RANK="0", WORLD_SIZE="1", MASTER_ADDR="localhost", MASTER_PORT=%r)
distributed.init(device="cpu")
distributed.init(coordinator_address="localhost:1", num_processes=1, process_id=0)
print("GROUP", distributed.world_size(), distributed.rank(), distributed.is_main())
try:
    distributed.init(coordinator_address="localhost:1", num_processes=2, process_id=0)
except RuntimeError as e:
    print("CONFLICT RAISED", e)
"""


@pytest.fixture(scope="module")
def init_probe():
    out = subprocess.run([sys.executable, "-c", _INIT_PROBE % (_REPO, str(_free_port()))],
                         env=_env(), cwd=_REPO, capture_output=True, text=True, timeout=120)
    return out.stdout + out.stderr


def test_init_explicit_misconfiguration_raises(init_probe):
    assert "EXPLICIT RAISED ValueError" in init_probe, init_probe


def test_init_autodetect_is_noop_off_cluster(init_probe):
    assert "AUTODETECT 1 None" in init_probe, init_probe


def test_init_conflicting_reinit_raises(init_probe):
    assert "GROUP 1 0 True" in init_probe, init_probe
    assert "CONFLICT RAISED distributed.init(num_processes=2)" in init_probe, init_probe


# (b) ----------------------------------------------------------------------

@pytest.mark.parametrize("path", ["k3", "autograd"])
def test_shardmap_update_matches_jax(runs, path):
    out_dir, (s_ref, m_ref) = runs
    got = _load(out_dir, f"shardmap_{path}")
    for field in ("params", "opt_state", "obs_norm", "ret_norm", "kl_beta"):
        _bitwise(getattr(got[0]["state"], field), getattr(got[1]["state"], field), field)
    assert got[0]["summary"] == got[1]["summary"]
    state, summary = got[0]["state"], got[0]["summary"]
    _close(state.params, networks.params_from_jax(jax.tree.map(np.asarray, s_ref.params)),
           "params")
    adam = ppo.adam_state_from_jax(jax.tree.map(np.asarray, s_ref.opt_state))
    assert int(state.opt_state.count) == int(adam.count) == 4
    _close(state.opt_state.mu, adam.mu, "adam mu")
    _close(state.opt_state.nu, adam.nu, "adam nu")
    for name, a, b in (("obs_norm", state.obs_norm, s_ref.obs_norm),
                       ("ret_norm", state.ret_norm, s_ref.ret_norm)):
        for i, (x, y) in enumerate(zip(a, b)):
            _close(x, y, f"{name}[{i}]")
    assert set(summary) == set(m_ref)
    for name in m_ref:
        _close(summary[name], float(m_ref[name]), name)


def test_shardmap_refuses_what_it_cannot_run():
    env = reinmav_tpu_torch.make("quadrotor3d-v0")
    two = Mesh(None, 2, 0, torch.device("cpu"))
    with pytest.raises(ValueError, match="not divisible"):
        ppo.make_train_step_shardmap(env, ppo.PpoConfig(num_envs=33), two)
    with pytest.raises(ValueError, match="not divisible"):
        sac.make_train_iters(env, sac.SacConfig(num_envs=33), 1, two)
    cfg = ppo.PpoConfig(num_envs=16, rollout_len=4, num_epochs=1, num_minibatches=2)
    state = ppo.init_train_state(env, cfg, 0, device="cpu")
    with pytest.raises(ValueError, match="fused_update refused"):
        ppo.train_step(env, cfg, state, fused_update=True, axis=CPU1)


# (c) ----------------------------------------------------------------------

def _one_rank_mesh(name: str):
    env, s64, s32 = mesh_states()
    cfg, state = {"f64": (MESH_CFG, s64), "twins": (MESH_TWIN_CFG, s32)}[name]
    for _ in range(MESH_STEPS):
        state, summary = ppo.train_step(env, cfg, state)
    return state, summary


@pytest.mark.parametrize("name", ["f64", "twins"])
def test_mesh_mode_equals_one_rank(runs, name):
    out_dir, _ = runs
    got = [g[name] for g in _load(out_dir, "mesh")]
    ref, ref_summary = _one_rank_mesh(name)
    tol = dict(rtol=1e-10, atol=1e-12) if name == "f64" else dict(rtol=1e-5, atol=1e-7)
    for g in got:
        s = g["state"]
        _bitwise(s.params, got[0]["state"].params, "the replicas' params")
        _close(s.params, ref.params, "params", **tol)
        _close(s.opt_state.mu, ref.opt_state.mu, "adam mu", **tol)
        for i, (x, y) in enumerate(zip((*s.obs_norm, *s.ret_norm),
                                       (*ref.obs_norm, *ref.ret_norm))):
            _close(x, y, f"normaliser {i}", **tol)
        for k, v in ref_summary.items():
            _close(g["summary"][k], float(v), k, **tol)
    states = torch.cat([g["state"].env_states for g in got])
    _close(states, ref.env_states, "env states", **tol)
    assert got[0]["state"].update_step == ref.update_step == MESH_STEPS


def test_sharded_control_rollout_matches_one_rank(runs):
    out_dir, _ = runs
    got = [g["rollout"] for g in _load(out_dir, "mesh")]
    env = reinmav_tpu_torch.make("quadrotor3d-v0")
    states = env.vreset(torch.Generator().manual_seed(11), ROLLOUT_BATCH).double()
    final, traj = reinmav_tpu_torch.control_rollout(env, states, torch.Generator(), ROLLOUT_T,
                                                    auto_reset=False)
    _close(torch.cat([g["final"] for g in got]), final, "final states", rtol=1e-12, atol=1e-12)
    assert got[0]["dones"] == got[1]["dones"] == int(traj.done.sum())


def test_sharded_dense_rollout_matches_jax(runs):
    """Each rank's shard against JAX's sharded_dense_rollout on 2 devices
    (no env resets in the horizon), and deterministic per seed."""
    out_dir, _ = runs
    z = np.load(os.path.join(out_dir, "dense.npz"))
    assert int(z["jax_dones"]) == 0
    got = [g["dense"] for g in _load(out_dir, "helpers")]
    for g in got:
        _bitwise(g[0], g[1], "a rerun of the same seed")
    _close(torch.cat([g[0][0] for g in got]), z["jax_final"], "final states", rtol=1e-10,
           atol=1e-12)
    _close(torch.cat([g[0][1] for g in got]), z["jax_rewards"], "reward sums", rtol=1e-10,
           atol=1e-12)


def test_sharded_dense_rollout_folds_the_rank_into_its_resets(runs):
    """The same states on both ranks, every env resetting on its first
    step: each rank draws its own reset stream, so the two ranks' results
    part."""
    out_dir, _ = runs
    (f0, r0), (f1, r1) = [g["far"] for g in _load(out_dir, "helpers")]
    assert bool(torch.isfinite(f0).all() and torch.isfinite(f1).all())
    assert not torch.equal(f0, f1) and not torch.equal(r0, r1)


def test_mesh_batch_helpers_on_two_ranks(runs):
    """shard_batch, batch_sharding, replicated and the distributed batch
    helpers on two gloo ranks."""
    out_dir, _ = runs
    got = _load(out_dir, "helpers")
    for r, g in enumerate(got):
        rows = slice(8 * r, 8 * (r + 1))
        assert g["rows"] == rows
        shard = g["shard"]
        assert torch.equal(shard["a"], torch.arange(64, dtype=torch.float64).reshape(16, 4)[rows])
        assert isinstance(shard["b"], ppo.ObsNorm)
        assert torch.equal(shard["b"].count, -torch.arange(16)[rows])
        assert torch.equal(shard["c"][0], (torch.arange(16) * 2)[rows]) and shard["n"] == 7
        assert torch.equal(g["replicated"], torch.ones(3))
        assert g["local_batch"] == 32
        assert "not divisible by 2" in g["refused"]
        assert torch.equal(g["global"], torch.full((4, 2), r))
    with pytest.raises(ValueError, match="not divisible"):
        Mesh(None, 2, 1, CPU1.device).shard(33)


def test_mesh_step_at_one_rank_is_train_step():
    """With one rank and no group the mesh mode is bitwise the plain step."""
    env = reinmav_tpu_torch.make("quadrotor3d-v0")
    cfg = ppo.PpoConfig(num_envs=32, rollout_len=4, num_epochs=1, num_minibatches=2,
                        hidden=(16, 16))
    a = ppo.init_train_state(env, cfg, 1, device="cpu")
    b = shard_state(CPU1, ppo.init_train_state(env, cfg, 1, device="cpu"))
    for _ in range(2):
        a, ma = ppo.train_step(env, cfg, a)
        b, mb = ppo.mesh_train_step(env, cfg, b, CPU1)
    _bitwise(a._replace(generator=None), b._replace(generator=None), "state")
    assert {k: float(v) for k, v in ma.items()} == {k: float(v) for k, v in mb.items()}
    assert make_mesh("cpu") == CPU1


# (d) ----------------------------------------------------------------------

MODULES = {"sac": (sac, SAC_CFG), "td3": (td3, TD3_CFG)}


@pytest.mark.parametrize("name", list(MODULES))
def test_offpolicy_update_is_the_union_batch(runs, name):
    out_dir, _ = runs
    module, cfg = MODULES[name]
    env = reinmav_tpu_torch.make("MujocoQuadForce-v1")
    inputs = [off_update_inputs(100 + r, env, cfg, module) for r in range(2)]
    ring = torch.cat([i[0] for i in inputs], dim=1)
    u = ((torch.arange(2 * OFF_BATCH, dtype=torch.float64) + 0.5) / (2 * OFF_BATCH)).float()
    eps = [torch.cat(e, dim=1) for e in zip(*(i[2] for i in inputs))]
    ref, _ = off_update(module, env, cfg, off_nets(module, env, cfg, 7), ring, u, eps)
    got = [g[name]["update"] for g in _load(out_dir, "offpolicy")]
    _bitwise(got[0], got[1], "the replicas")
    for field, x, y in zip(module.Nets._fields, got[0], ref):
        for i, (a, b) in enumerate(zip(x if isinstance(x, tuple) else (x,),
                                       y if isinstance(y, tuple) else (y,))):
            _close(a, b, f"{field}[{i}]", rtol=1e-10, atol=1e-13)


@pytest.mark.parametrize("name", list(MODULES))
def test_offpolicy_replicas_stay_bitwise_equal(runs, name):
    out_dir, _ = runs
    got = [g[name] for g in _load(out_dir, "offpolicy")]
    a, b = got[0]["iters"], got[1]["iters"]
    module, cfg = MODULES[name]
    for field in a._fields:
        if field not in ("buffer", "env_states", "ever_done", "generator"):
            _bitwise(getattr(a, field), getattr(b, field), field)
    assert not torch.equal(a.env_states, b.env_states)  # each rank its own envs
    assert a.buffer.shape[1] * 2 == sac._capacity(cfg, reinmav_tpu_torch.make(
        "MujocoQuadForce-v1"))
    assert int(a.total_steps) == 8 * cfg.num_envs  # the global count, as JAX's
    assert got[0]["metrics"] == got[1]["metrics"]
    assert all(np.isfinite(v) for v in got[0]["metrics"].values())


# (e) ----------------------------------------------------------------------

@pytest.mark.parametrize("name", ["ppo", "sac"])
def test_collective_checkpoint_resumes_bitwise(runs, name):
    out_dir, _ = runs
    ref, got = _load(out_dir, "ckpt_ref"), _load(out_dir, "ckpt_resumed")
    for r in range(2):
        a, b = ref[r][name], got[r][name]
        assert len(a) == len(b)
        for i, (x, y) in enumerate(zip(a, b)):
            assert x.dtype == y.dtype and torch.equal(x, y), f"rank {r} leaf {i}"
    assert os.path.isfile(os.path.join(out_dir, f"ckpt_{name}", "shard_1.pt"))


def test_checkpoint_refuses_another_world_size(runs):
    out_dir, _ = runs
    env = reinmav_tpu_torch.make("quadrotor3d-v0")
    target = ppo.init_train_state(env, CKPT_PPO, 0, device="cpu")
    with pytest.raises(ckpt.CheckpointStructureError, match="written by 2 rank"):
        ckpt.restore(os.path.join(out_dir, "ckpt_ppo"), target)
    with pytest.raises(ckpt.CheckpointStructureError, match="written by 2 rank"):
        ckpt.restore(os.path.join(out_dir, "ckpt_ppo"), target, Mesh(None, 3, 0, CPU1.device))
