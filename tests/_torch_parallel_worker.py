"""One rank of tests/test_torch_parallel.py's two-rank gloo runs on the CPU.

Run as ``python tests/_torch_parallel_worker.py PORT WORLD RANK DIR PHASE``:
the rank joins the group at ``localhost:PORT`` in explicit mode, reads its
inputs from ``DIR`` (the JAX side's draws in ``ppo_shardmap.npz``, written
by the parent, so that no worker imports JAX), and writes what it computed
to ``DIR/<case>_rank<RANK>.pt`` for the parent to compare.  ``PHASE``
``main`` runs every case and saves the collective checkpoints;
``restore`` restores them in a fresh group and resumes.

The configs and the float64 conversions are here, so that the parent's
one-rank runs use the same ones.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _REPO not in sys.path:
    sys.path.insert(0, _REPO)

import reinmav_tpu_torch  # noqa: E402
from reinmav_tpu_torch.parallel import (batch_sharding, distributed, make_mesh,  # noqa: E402
                                        replicated, shard_batch, shard_state,
                                        sharded_control_rollout, sharded_dense_rollout)
from reinmav_tpu_torch.rl import ppo, sac, td3  # noqa: E402
from reinmav_tpu_torch.utils import checkpoint as ckpt  # noqa: E402

#: (b): the JAX shard_map update's config (tests/test_torch_ppo.py's).
SHARDMAP_CFG = dict(num_envs=64, rollout_len=8, num_epochs=2, num_minibatches=2,
                    entropy_coef=0.01)
#: (c): the mesh mode in float64 through the eager rollout and autograd,
#: and in float32 through the K2 and K4 twins.
MESH_CFG = ppo.PpoConfig(num_envs=64, rollout_len=8, num_epochs=2, num_minibatches=2,
                         hidden=(16, 16), fused_rollout="off", fused_loss="off",
                         fused_update="off")
MESH_TWIN_CFG = ppo.PpoConfig(num_envs=256, rollout_len=8, num_epochs=2, num_minibatches=2,
                              fused_rollout="on", fused_loss="on", fused_update="on")
MESH_STEPS = 2
#: (d): the off-policy configs, and the update_step batch per rank.
SAC_CFG = sac.SacConfig(num_envs=32, buffer_capacity=256, batch_size=16, hidden=(16, 16),
                        warmup_steps=0)
TD3_CFG = td3.Td3Config(num_envs=32, buffer_capacity=256, batch_size=16, hidden=(16, 16),
                        warmup_steps=0, policy_delay=1)
OFF_BATCH, OFF_ITERS = 12, 8
ROLLOUT_BATCH, ROLLOUT_T = 16, 30
#: (c): sharded_dense_rollout's global batch and horizon.
DENSE_B, DENSE_T = 64, 50
#: (e): the checkpoint runs.
CKPT_PPO = ppo.PpoConfig(num_envs=32, rollout_len=8, num_epochs=1, num_minibatches=2,
                         hidden=(16, 16))


def ppo_to64(state: ppo.TrainState) -> ppo.TrainState:
    """A PPO state with its floating tensors in float64."""
    d = lambda t: t.to(torch.float64)  # noqa: E731
    return state._replace(
        params=d(state.params), opt_state=state.opt_state._replace(
            mu=d(state.opt_state.mu), nu=d(state.opt_state.nu)),
        env_states=d(state.env_states), obs_norm=ppo.ObsNorm(*map(d, state.obs_norm)),
        ret_norm=ppo.RetNorm(*map(d, state.ret_norm)), env_returns=d(state.env_returns),
        kl_beta=d(state.kl_beta))


def mesh_states(seed: int = 3):
    """The float64 and the float32 starting states of (c), global."""
    env = reinmav_tpu_torch.make("quadrotor3d-v0")
    return (env, ppo_to64(ppo.init_train_state(env, MESH_CFG, seed, device="cpu")),
            ppo.init_train_state(env, MESH_TWIN_CFG, seed, device="cpu"))


def off_nets(module, env, cfg, seed: int):
    """A learner's update nets (its ``Nets``) from ``seed``, in float64."""
    state = module.init_state(env, cfg, seed, device="cpu")

    def f64(x):
        if isinstance(x, ppo.AdamState):
            return x._replace(mu=x.mu.double(), nu=x.nu.double())
        return x.double() if x.is_floating_point() else x

    return module.Nets(*(f64(getattr(state, f)) for f in module.Nets._fields))


def off_update_inputs(seed: int, env, cfg, module):
    """Each rank's ring of ``OFF_BATCH`` columns, and its draws: the
    uniforms that pick the columns in order, standard normals."""
    gen = np.random.default_rng(seed)
    rows = sac._row_dims(env)
    ring = gen.normal(size=(rows, OFF_BATCH)).astype(np.float32)
    ring[-1] = (gen.random(OFF_BATCH) < 0.2).astype(np.float32)  # done
    u = ((np.arange(OFF_BATCH) + 0.5) / OFF_BATCH).astype(np.float32)
    n_normals = 2 if module is sac else 1
    eps = [gen.normal(size=(env.action_dim, OFF_BATCH)) for _ in range(n_normals)]
    return torch.from_numpy(ring), torch.from_numpy(u), [torch.from_numpy(e) for e in eps]


def off_update(module, env, cfg, nets, ring, u, eps, axis=None):
    """One ``update_step`` from a full ring read in column order."""
    draws = module.Draws(u, *eps)
    filled = torch.tensor(ring.shape[1], dtype=torch.int64)
    cfg = cfg._replace(batch_size=ring.shape[1])
    return module.update_step(env, cfg, nets, ring, filled, torch.tensor(True), draws, 1, axis)


def leaves(tree) -> list:
    """Every tensor of a state tree, the generator as its state."""
    if isinstance(tree, torch.Generator):
        return [tree.get_state()]
    if isinstance(tree, torch.Tensor):
        return [tree.detach().clone()]
    if isinstance(tree, tuple):
        return [leaf for x in tree for leaf in leaves(x)]
    return [torch.tensor(tree)] if isinstance(tree, (int, float)) else []


def _save(out_dir: str, name: str, rank: int, obj) -> None:
    torch.save(obj, os.path.join(out_dir, f"{name}_rank{rank}.pt"))


def shardmap_case(mesh, out_dir: str) -> None:
    """(b): this rank's update_phase under shard_map from the JAX draws."""
    z = np.load(os.path.join(out_dir, "ppo_shardmap.npz"))
    r = mesh.rank
    t = lambda k: torch.from_numpy(np.array(z[k]))  # noqa: E731
    env = reinmav_tpu_torch.make("quadrotor3d-v0")
    cfg = ppo.PpoConfig(**SHARDMAP_CFG)
    state = ppo.TrainState(
        t("params"), ppo.AdamState(t("count"), t("mu"), t("nu")), t(f"final_{r}"),
        ppo.ObsNorm(t("obs_mean"), t("obs_var"), t("obs_count")),
        ppo.RetNorm(t("ret_var"), t("ret_count")), t(f"rets_{r}"),
        torch.Generator().manual_seed(0), 0, t("kl_beta"))
    rollout = ppo.Rollout(
        t(f"final_{r}"), t(f"rets_{r}"),
        ppo.Transition(*(t(f"traj_{f}_{r}") for f in ppo.Transition._fields)),
        ppo.RawObsMoments(*(t(f"omom_{i}_{r}") for i in range(3))),
        ppo.RawObsMoments(*(t(f"rmom_{i}_{r}") for i in range(3))), t(f"raw_{r}"))
    perms = [t("perms")[e] for e in range(cfg.num_epochs)]
    for fused_loss in (True, False):
        new, summary = ppo.update_phase(env, cfg, state, rollout, perms, fused_loss, axis=mesh)
        _save(out_dir, f"shardmap_{'k3' if fused_loss else 'autograd'}", r,
              {"state": new._replace(generator=None),
               "summary": {k: float(v) for k, v in summary.items()}})


def mesh_case(mesh, out_dir: str) -> None:
    """(c): the mesh mode from the global starting states; the sharded
    control rollout without resets."""
    env, s64, s32 = mesh_states()
    out = {}
    for name, cfg, state in (("f64", MESH_CFG, s64), ("twins", MESH_TWIN_CFG, s32)):
        state = shard_state(mesh, state)
        for _ in range(MESH_STEPS):
            state, summary = ppo.mesh_train_step(env, cfg, state, mesh)
        out[name] = {"state": state._replace(generator=None),
                     "summary": {k: float(v) for k, v in summary.items()}}
    gen = torch.Generator().manual_seed(11)
    run, init = sharded_control_rollout(env, mesh, ROLLOUT_BATCH, ROLLOUT_T, gen,
                                        auto_reset=False)
    final, dones = run(init.double(), 5)
    out["rollout"] = {"final": final, "dones": int(dones)}
    _save(out_dir, "mesh", mesh.rank, out)


def helpers_case(mesh, out_dir: str) -> None:
    """(c): sharded_dense_rollout from the JAX side's states (twice, for
    determinism) and from states that reset on their first step, the same
    on both ranks (the reset streams folded with the rank); the batch helpers."""
    z = np.load(os.path.join(out_dir, "dense.npz"))
    env = reinmav_tpu_torch.make("quadrotor3d-v0")
    local = shard_batch(mesh, torch.from_numpy(z["states"]))
    dense = [sharded_dense_rollout(env, mesh, local, 5, DENSE_T) for _ in range(2)]
    far = sharded_dense_rollout(env, mesh, torch.from_numpy(z["far"]), 5, DENSE_T)
    tree = {"a": torch.arange(64, dtype=torch.float64).reshape(16, 4),
            "b": ppo.ObsNorm(torch.arange(16), torch.ones(16), -torch.arange(16)),
            "c": (torch.arange(16) * 2,), "n": 7}
    try:
        distributed.host_local_batch_size(33)
        refused = None
    except ValueError as e:
        refused = str(e)
    out = {"dense": dense, "far": far, "shard": shard_batch(mesh, tree),
           "rows": batch_sharding(mesh, 16),
           "replicated": replicated(mesh, torch.full((3,), float(mesh.rank + 1))),
           "local_batch": distributed.host_local_batch_size(64), "refused": refused,
           "global": distributed.global_batch_array(mesh, np.full((4, 2), mesh.rank))}
    _save(out_dir, "helpers", mesh.rank, out)


def offpolicy_case(mesh, out_dir: str) -> None:
    """(d): one update_step from this rank's batch; then OFF_ITERS sharded
    train_iters."""
    out = {}
    for name, module, cfg in (("sac", sac, SAC_CFG), ("td3", td3, TD3_CFG)):
        env = reinmav_tpu_torch.make("MujocoQuadForce-v1")
        nets = off_nets(module, env, cfg, 7)
        ring, u, eps = off_update_inputs(100 + mesh.rank, env, cfg, module)
        new, _ = off_update(module, env, cfg, nets, ring, u, eps, mesh)
        state = shard_state(mesh, module.init_state(env, cfg, 9, device="cpu"))
        state, metrics = module.train_iters(env, cfg, state, OFF_ITERS, axis=mesh)
        out[name] = {"update": new, "iters": state._replace(generator=None),
                     "metrics": metrics}
    _save(out_dir, "offpolicy", mesh.rank, out)


def checkpoint_runs(mesh, seed: int):
    """(e)'s learners and their sharded starting states."""
    quad = reinmav_tpu_torch.make("quadrotor3d-v0")
    hover = reinmav_tpu_torch.make("MujocoQuadForce-v1")
    ppo_step = ppo.make_train_step_shardmap(quad, CKPT_PPO, mesh)
    sac_iter = sac.make_train_iters(hover, SAC_CFG, 1, mesh)
    return {
        "ppo": (lambda s: ppo_step(s)[0],
                shard_state(mesh, ppo.init_train_state(quad, CKPT_PPO, seed, device="cpu"))),
        "sac": (lambda s: sac_iter(s)[0],
                shard_state(mesh, sac.init_state(hover, SAC_CFG, seed, device="cpu"))),
    }


def checkpoint_save(mesh, out_dir: str) -> None:
    """(e): 4 steps straight (the reference), and 2 steps then a collective
    save."""
    ref = {}
    again = checkpoint_runs(mesh, 5)  # a state of its own: the generator advances in place
    for name, (step, straight) in checkpoint_runs(mesh, 5).items():
        for _ in range(4):
            straight = step(straight)
        ref[name] = leaves(straight)
        state = again[name][1]
        for _ in range(2):
            state = step(state)
        ckpt.save(os.path.join(out_dir, f"ckpt_{name}"), state, mesh)
    _save(out_dir, "ckpt_ref", mesh.rank, ref)


def checkpoint_restore(mesh, out_dir: str) -> None:
    """(e): a fresh group restores into states of another seed and runs
    the last 2 steps."""
    got = {}
    for name, (step, target) in checkpoint_runs(mesh, 6).items():
        state = ckpt.restore(os.path.join(out_dir, f"ckpt_{name}"), target, mesh)
        for _ in range(2):
            state = step(state)
        got[name] = leaves(state)
    _save(out_dir, "ckpt_resumed", mesh.rank, got)


def main(argv) -> None:
    port, world, rank, out_dir, phase = argv
    distributed.init(coordinator_address=f"localhost:{port}", num_processes=int(world),
                     process_id=int(rank), device="cpu")
    mesh = make_mesh("cpu")
    assert (mesh.world_size, mesh.rank, mesh.backend) == (int(world), int(rank), "gloo"), mesh
    if phase == "main":
        shardmap_case(mesh, out_dir)
        mesh_case(mesh, out_dir)
        helpers_case(mesh, out_dir)
        offpolicy_case(mesh, out_dir)
        checkpoint_save(mesh, out_dir)
    else:
        checkpoint_restore(mesh, out_dir)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
