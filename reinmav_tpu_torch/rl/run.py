"""Train/play CLI of the PyTorch port: the learners of
:mod:`reinmav_tpu.rl.run`, on a CUDA device, or on several ranks under
``torchrun``.

Usage (the JAX package's flags; ``--device`` is the port's own)::

    python -m reinmav_tpu_torch.rl.run --alg=ppo --env=quadrotor3d-v0 \\
        --num_timesteps=1e7 --num_env=32768 --rollout_len=32 --save_path=./models/quad3d
    python -m reinmav_tpu_torch.rl.run --play --load_path=./models/quad3d \\
        --num_env=32768 --rollout_len=32
    python -m reinmav_tpu_torch.rl.run --alg=sac --env=MujocoQuadForce-v1 \\
        --num_env=8192 --batch_size=2048 --grad_steps=16 --updates_per_jit=64

``--alg`` ``ppo``, ``a2c`` (one epoch, one batch, no ratio clipping) and
``ppo_kl`` (the adaptive-KL penalty): on the card every update is one
launch of the fused rollout (K2 on quadrotor3d-v0, K6 on the hover task,
quadrotor2d-v0 and the slung-load envs) and one K4 launch for the update
(:func:`reinmav_tpu_torch.rl.ppo.train_step` logs which paths ran).
``--num_hidden`` sets the width of both layers: at 64 the fused rollout
and the 64-wide K4 run; at any other width up to 256 the rollout is the
eager loop (the fused rollout is 2 x 64 only, as the JAX package's) and
the update one launch of K4's wide instance (the log names it, "K4 CUDA
kernel (wide, H=256)"); wider layers train through autograd, with a log
line saying why.
``--alg`` ``sac``, ``td3`` and ``ddpg`` (TD3 with one critic, no target
smoothing and no delay): every iteration is one batched env step, one K7
launch on the card at any ``--num_hidden`` up to 1024 (K7's wide instance
past 256; :func:`reinmav_tpu_torch.rl.sac.train_iters` logs the path,
"K7 CUDA kernel (wide, H=(512, 512))"), and ``--grad_steps`` updates from
the replay ring;
``--updates_per_jit`` iterations make one call between metric reads.
``--network=gru`` (with ``--alg=ppo`` only) trains the GRU actor-critic
of :mod:`reinmav_tpu_torch.rl.recurrent`, hidden and embedding widths
``--num_hidden``: eager, no kernel, as the JAX package's (it has no
Pallas kernel for the GRU).
``--device=cpu`` runs the same loops on the CPU, through the kernels'
plain twins.

``--play`` rolls one env out with the greedy policy (the PPO, off-policy
or GRU one; the GRU hidden carried and masked on each episode's end);
``--gif`` and ``--html`` write that rollout as a GIF or a self-contained
HTML animation, ``--live`` serves it to a browser while it steps
(``--live_port``, 0 for any free port; ``--live_hold`` seconds kept up
after the end).  ``--compute_dtype=bfloat16`` runs every learner's
products with bf16 operands and float32 sums (the bf16 instances of K2/K6,
K4 and K7 on the card).

Several ranks (:mod:`reinmav_tpu_torch.parallel`)::

    torchrun --nproc_per_node=N -m reinmav_tpu_torch.rl.run --num_env=32768 ...
    torchrun --nproc_per_node=N -m reinmav_tpu_torch.rl.run --shard_map ...

Unless ``--no_mesh`` (one process, no group), the CLI forms the group from
torchrun's environment (a no-op for a plain ``python -m`` run) and splits
``--num_env`` over the ranks.  PPO then runs the mesh mode by default (the
one-rank update on the split batch, K2/K6 and K4 on every rank) and with
``--shard_map`` the fast path (each rank its own rollout stream and
minibatches, each minibatch's gradient all-reduced, K3 on the card); its
checkpoints are collective.  The off-policy and GRU paths stay unsharded,
as the JAX CLI's.  Logs, evaluation and play run on rank 0 only.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import time

import torch

from .. import make
from ..parallel import distributed, make_mesh, shard_state
from ..utils import checkpoint as ckpt
from ..utils.metrics import MetricsLogger, to_host
from . import evaluate, networks, ppo, recurrent, sac, td3

OFF_POLICY = ("sac", "td3", "ddpg")


def build_parser() -> argparse.ArgumentParser:
    # The JAX package's flag names and defaults (reinmav_tpu/rl/run.py).
    p = argparse.ArgumentParser(description="PyTorch + CUDA RL training for reinmav envs")
    p.add_argument("--env", default="quadrotor3d-v0")
    p.add_argument("--alg", default="ppo", choices=["ppo", "a2c", "ppo_kl", *OFF_POLICY],
                   help="a2c = one epoch, one batch, no ratio clipping; ppo_kl = the "
                        "adaptive-KL penalty (beta adapted to --kl_target); sac = soft "
                        "actor-critic with the replay ring on the device; td3 = twin-delayed "
                        "DDPG on the same ring; ddpg = td3 with one critic, policy_noise=0 and "
                        "policy_delay=1")
    p.add_argument("--network", default="mlp", choices=["mlp", "gru"],
                   help="policy network for --alg=ppo: the 2-layer MLP, or a GRU actor-critic "
                        "(rl/recurrent.py; sequences train whole, minibatched over envs)")
    # Off-policy flags (the on-policy algs ignore them).
    p.add_argument("--buffer_capacity", type=int, default=1 << 20)
    p.add_argument("--batch_size", type=int, default=2048)
    p.add_argument("--grad_steps", type=int, default=1,
                   help="off-policy gradient updates per collected env step")
    p.add_argument("--warmup_steps", type=int, default=10_000)
    p.add_argument("--tau", type=float, default=0.005)
    p.add_argument("--reward_scale", type=float, default=1.0)
    p.add_argument("--target_entropy", type=float, default=None,
                   help="SAC entropy target (default -action_dim)")
    p.add_argument("--sample_tile", default="auto", type=lambda v: v if v == "auto" else int(v),
                   help="replay gather granularity: 'auto' = exact uniform tile 1; an int "
                        "gathers contiguous column blocks (correlated; for experiments)")
    p.add_argument("--explore_noise", type=float, default=0.1,
                   help="TD3/DDPG collection-time action-noise std")
    p.add_argument("--policy_noise", type=float, default=0.2,
                   help="TD3 target-smoothing noise std")
    p.add_argument("--policy_delay", type=int, default=2,
                   help="TD3 critic updates per actor/target update")
    p.add_argument("--kl_target", type=float, default=0.01,
                   help="per-update KL target for --alg=ppo_kl")
    p.add_argument("--num_timesteps", type=float, default=1e6)
    p.add_argument("--num_env", type=int, default=1024)
    p.add_argument("--rollout_len", type=int, default=128)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--gamma", type=float, default=0.99)
    p.add_argument("--lam", type=float, default=0.95)
    p.add_argument("--clip", type=float, default=0.2)
    p.add_argument("--num_layers", type=int, default=2)
    p.add_argument("--num_hidden", type=int, default=64,
                   help="width of each hidden layer; PPO on the card runs K3/K4 up to 256 (the "
                        "64-wide instances at 64, the wide ones otherwise), autograd above; "
                        "SAC/TD3/DDPG collect through K7 up to 1024 (its wide instance past "
                        "256), eagerly above")
    p.add_argument("--compute_dtype", default="float32", choices=("float32", "bfloat16"),
                   help="bfloat16: the policy/value products take bf16 operands with float32 "
                        "sums; params and optimiser state stay float32")
    p.add_argument("--ent_coef", type=float, default=0.0)
    p.add_argument("--log_std_floor", type=float, default=None,
                   help="lower clamp on the policy log-std after each optimiser step")
    p.add_argument("--save_path", default=None)
    p.add_argument("--load_path", default=None)
    p.add_argument("--save_interval", type=int, default=50)
    p.add_argument("--log_interval", type=int, default=10)
    p.add_argument("--updates_per_jit", type=int, default=1,
                   help="updates (PPO) or iterations (sac/td3/ddpg) per call between metric "
                        "reads")
    p.add_argument("--log_dir", default=None)
    p.add_argument("--eval_interval", type=int, default=0,
                   help="greedy-policy evaluation every N logged updates (0=off)")
    p.add_argument("--eval_envs", type=int, default=256)
    p.add_argument("--eval_horizon", type=int, default=1000)
    p.add_argument("--play", action="store_true")
    p.add_argument("--play_steps", type=int, default=1000)
    p.add_argument("--live", action="store_true",
                   help="serve a live browser view of the --play rollout while it steps "
                        "(prints the URL)")
    p.add_argument("--live_port", type=int, default=0, help="port for --live (0 = any free port)")
    p.add_argument("--live_hold", type=float, default=0.0,
                   help="keep the --live server up this many seconds after the rollout ends")
    p.add_argument("--gif", default=None, help="write the play rollout as a GIF")
    p.add_argument("--html", default=None,
                   help="write the play rollout as a self-contained HTML animation")
    p.add_argument("--no_mesh", action="store_true",
                   help="one process with no group: torchrun's environment is not read")
    p.add_argument("--shard_map", action="store_true",
                   help="PPO's fast mesh path: per-rank rollouts and minibatches, each "
                        "minibatch's gradient all-reduced (needs a mesh)")
    p.add_argument("--device", default="cuda",
                   help="torch device to train on (the port's own flag; cpu runs the plain twins)")
    return p


def refuse_missing_renderer(args) -> None:
    """``--gif`` draws its frames with matplotlib and writes them with PIL:
    exit before any training when either is not installed."""
    missing = [m for m in ("matplotlib", "PIL") if importlib.util.find_spec(m) is None]
    if args.gif and missing:
        raise SystemExit(f"--gif needs {' and '.join(missing)}, which is not installed "
                         "(--html needs neither)")


def make_config(args) -> ppo.PpoConfig:
    cfg = ppo.PpoConfig(
        num_envs=args.num_env,
        rollout_len=args.rollout_len,
        learning_rate=args.lr,
        gamma=args.gamma,
        gae_lambda=args.lam,
        clip_eps=args.clip,
        entropy_coef=args.ent_coef,
        log_std_floor=args.log_std_floor,
        hidden=tuple([args.num_hidden] * args.num_layers),
        compute_dtype=args.compute_dtype,
    )
    if args.alg == "a2c":
        # With one epoch over the fresh rollout the ratio is 1, so the
        # unclipped PPO surrogate IS the A2C objective.
        cfg = cfg._replace(num_epochs=1, num_minibatches=1, clip_eps=1e9, value_clip_eps=1e9)
    elif args.alg == "ppo_kl":
        cfg = cfg._replace(kl_target=args.kl_target)
    return cfg


def _device(args):
    """The rank's device (the one the group gave it), else ``--device``."""
    return distributed.device() or args.device


def _eval_generator(args, update: int) -> torch.Generator:
    """The evaluation's own stream, so that evaluating leaves training's
    generator untouched."""
    return torch.Generator(device=_device(args)).manual_seed(args.seed * 1_000_003 + update)


def setup_mesh(args):
    """The run's mesh: None with ``--no_mesh``; else the group that
    :func:`reinmav_tpu_torch.parallel.distributed.init` forms from
    torchrun's environment (none for a plain run: one rank, no group)."""
    if args.no_mesh:
        return None
    distributed.init(device=args.device)
    return make_mesh(args.device)


def _ppo_state(env, cfg, args, mesh):
    """A fresh PPO state on the rank's device, cut to its shard, restored
    (collectively) from ``--load_path`` when given."""
    state = ppo.init_train_state(env, cfg, args.seed,
                                 device=_device(args) if mesh is None else mesh.device)
    if mesh is not None:
        state = shard_state(mesh, state)
    if args.load_path:
        state = ckpt.restore(args.load_path, state, mesh)
    return state


def train(args, mesh=None) -> ppo.TrainState:
    """The PPO loop: calls of ``--updates_per_jit`` updates, the mesh mode
    across the ranks of ``mesh`` (``--shard_map``: the shard_map step),
    rank 0 logging and evaluating, the checkpoints collective."""
    env = make(args.env)
    cfg = make_config(args)
    k = max(1, args.updates_per_jit)
    if args.shard_map and mesh is None:
        raise SystemExit("--shard_map requires a mesh (drop --no_mesh)")
    if args.shard_map:
        step_fn = ppo.make_train_many_shardmap(env, cfg, k, mesh)
    else:
        # One rank with no group is the plain step (the mesh mode's own
        # at world size 1, without the identity collectives).
        grouped = mesh if mesh is not None and mesh.group is not None else None
        step_fn = ppo.make_train_many(env, cfg, k, grouped)
    state = _ppo_state(env, cfg, args, mesh)

    steps_per_update = cfg.num_envs * cfg.rollout_len
    num_updates = max(1, int(args.num_timesteps) // steps_per_update)
    logger = MetricsLogger(log_dir=args.log_dir, config=vars(args))
    last_t, last_update, update = time.perf_counter(), 0, 0
    while update < num_updates:
        state, metrics = step_fn(state)
        update += k
        if (update // k) % args.log_interval == 0 or update >= num_updates:
            # The metrics depend on the update, so reading them to the host
            # (one copy) ends the interval only when the device has finished.
            host = to_host(metrics)
            now = time.perf_counter()
            sps = steps_per_update * (update - last_update) / max(now - last_t, 1e-9)
            last_t, last_update = now, update
            logger.log(update, {"env_steps": steps_per_update * update,
                                "steps_per_sec": round(sps), **host})
        if args.eval_interval and (update // k) % args.eval_interval == 0 and distributed.is_main():
            stats = evaluate.evaluate(env, state.params,
                                      state.obs_norm if cfg.normalize_obs else None,
                                      _eval_generator(args, update), num_envs=args.eval_envs,
                                      horizon=args.eval_horizon, hidden=cfg.hidden)
            _log_eval(logger, update, stats)
        # Collective: every rank writes its shard.
        if args.save_path and (update // k) % args.save_interval == 0:
            ckpt.save(args.save_path, state, mesh)
    if args.save_path:
        ckpt.save(args.save_path, state, mesh)
    logger.close()
    return state


def offpolicy_config(args):
    """``--alg=sac|td3|ddpg`` -> (learner module, config), as the JAX
    package's ``_offpolicy_alg_cfg``: DDPG is TD3 with ``single_critic``,
    ``policy_noise=0``, ``noise_clip=0`` and ``policy_delay=1``.  Training
    and play build the same config, since the checkpoint carries the
    ring."""
    common = dict(num_envs=args.num_env, buffer_capacity=args.buffer_capacity,
                  batch_size=args.batch_size, learning_rate=args.lr, gamma=args.gamma,
                  tau=args.tau, grad_steps=args.grad_steps, warmup_steps=args.warmup_steps,
                  reward_scale=args.reward_scale, sample_tile=args.sample_tile,
                  hidden=tuple([args.num_hidden] * args.num_layers),
                  compute_dtype=args.compute_dtype)
    if args.alg == "sac":
        return sac, sac.SacConfig(target_entropy=args.target_entropy, **common)
    if args.alg == "ddpg":
        return td3, td3.Td3Config(explore_noise=args.explore_noise, policy_noise=0.0,
                                  noise_clip=0.0, policy_delay=1, single_critic=True, **common)
    return td3, td3.Td3Config(explore_noise=args.explore_noise, policy_noise=args.policy_noise,
                              policy_delay=args.policy_delay, **common)


def train_offpolicy(args):
    """The off-policy loop (``--alg=sac|td3|ddpg``): calls of
    ``train_iters`` of ``--updates_per_jit`` iterations each, one batched
    env step and ``--grad_steps`` updates an iteration."""
    env = make(args.env)
    alg, cfg = offpolicy_config(args)
    k = max(1, args.updates_per_jit)
    state = alg.init_state(env, cfg, args.seed, device=_device(args))
    if args.load_path:
        state = ckpt.restore(args.load_path, state)
    steps_per_call = cfg.num_envs * k
    num_calls = max(1, int(args.num_timesteps) // steps_per_call)
    logger = MetricsLogger(log_dir=args.log_dir, config=vars(args))
    last_t, last_call = time.perf_counter(), 0
    for call in range(1, num_calls + 1):
        # train_iters reads its metrics to the host, so the call has ended
        # on the device when it returns.
        state, metrics = alg.train_iters(env, cfg, state, k)
        if call % args.log_interval == 0 or call == num_calls:
            now = time.perf_counter()
            sps = steps_per_call * (call - last_call) / max(now - last_t, 1e-9)
            last_t, last_call = now, call
            logger.log(call, {"env_steps": steps_per_call * call, "steps_per_sec": round(sps),
                              **metrics})
        if args.eval_interval and call % args.eval_interval == 0 and distributed.is_main():
            stats = evaluate.evaluate_actor(env, alg, state.actor, cfg.hidden,
                                            _eval_generator(args, call), num_envs=args.eval_envs,
                                            horizon=args.eval_horizon)
            _log_eval(logger, call, stats)
        if args.save_path and call % args.save_interval == 0:
            _save_replica(args.save_path, state)
    if args.save_path:
        _save_replica(args.save_path, state)
    logger.close()
    return state


def _save_replica(path: str, state) -> None:
    """The unsharded paths' checkpoint: every rank holds the same replica,
    so rank 0 writes it alone."""
    if distributed.is_main():
        ckpt.save(path, state)


def _log_eval(logger: MetricsLogger, step: int, stats: evaluate.EvalStats) -> None:
    logger.log(step, {"eval_mean_return": stats.mean_return,
                      "eval_mean_length": stats.mean_length,
                      "eval_episodes": stats.num_episodes,
                      "eval_running_return": stats.mean_running_return,
                      "eval_survival_frac": stats.survival_frac})


@torch.no_grad()
def _greedy_rollout(env, args, device, policy, observe=None):
    """The ``--play`` loop: one env stepped with ``policy(state (D,)) ->
    action (A,)``, reset on each episode's end (done or truncated);
    ``observe(step_out)``, if given, sees each step.  With ``--live`` each
    observation streams to the browser viewer as the loop runs.  Returns
    ``(observations (play_steps, obs_dim) on the CPU, total reward,
    episodes)``."""

    def reset(seed):
        return env.reset(torch.Generator(device=device).manual_seed(seed))

    viewer = None
    if args.live:
        from ..render import LiveViewer

        viewer = LiveViewer(args.env, port=args.live_port)
        print(f"# live view: {viewer.url}", flush=True)
    try:
        s = reset(args.seed + 1)
        total_reward, episodes, obs = 0.0, 0, []
        for t in range(args.play_steps):
            out = env.step(s, policy(s))
            if observe is not None:
                observe(out)
            total_reward += float(out.reward)
            obs.append(out.obs)
            if viewer is not None:
                viewer.push(out.obs)
            truncated = out.truncated is not None and bool(out.truncated)
            if bool(out.done) or truncated:
                episodes += 1
                s = reset(args.seed + 3 + t)
            else:
                s = out.state
        if viewer is not None:
            viewer.finish()
            if args.live_hold > 0:
                print(f"# live view held for {args.live_hold}s: {viewer.url}", flush=True)
                time.sleep(args.live_hold)
    finally:
        if viewer is not None:
            viewer.close()
    states = torch.stack(obs).cpu() if obs else torch.empty((0, env.obs_dim))
    return states, total_reward, episodes


def _emit_play_outputs(env, args, states, total_reward: float, episodes: int):
    """Write ``--gif`` / ``--html`` of the play rollout, print its JSON
    line, and return the observations."""
    if args.gif:
        from ..render import save_gif

        save_gif(env.name, states, args.gif)
    if args.html:
        from ..render import save_html

        save_html(env.name, states, args.html)
    print(json.dumps({"play_steps": args.play_steps, "episodes": episodes,
                      "total_reward": round(total_reward, 3),
                      **({"gif": args.gif} if args.gif else {}),
                      **({"html": args.html} if args.html else {})}))
    return states


def play(args, state: ppo.TrainState | None = None, mesh=None):
    """Deterministic greedy rollout of one env with the trained PPO policy
    (its mean action), resetting on each episode's end; on rank 0 only
    (the restore is collective)."""
    env = make(args.env)
    cfg = make_config(args)
    if state is None:
        # The restore target mirrors the training shapes (num_env and
        # rollout_len size the checkpoint's env states).
        state = _ppo_state(env, cfg, args, mesh)
    if not distributed.is_main():
        return None
    tree = networks.Layout(env.obs_dim, env.action_dim, cfg.hidden).unflatten(state.params)

    def policy(s):
        norm = ppo._normalize_t(s[:env.obs_dim, None], state.obs_norm)
        mean, _, _ = networks.apply_t(tree, norm)
        return mean[:, 0]

    return _emit_play_outputs(env, args, *_greedy_rollout(env, args, state.params.device, policy))


def play_offpolicy(args, state=None):
    """``--play`` for ``--alg=sac|td3|ddpg``: the noise-free actor's
    rollout of one env, resetting on each episode's end.  The restore
    target mirrors the training shapes (the checkpoint carries the ring),
    so pass the training run's ``--num_env``, ``--buffer_capacity`` and
    net flags."""
    env = make(args.env)
    alg, cfg = offpolicy_config(args)
    if state is None:
        state = alg.init_state(env, cfg, args.seed, device=_device(args))
        if args.load_path:
            state = ckpt.restore(args.load_path, state)
    if not distributed.is_main():
        return None
    rollout = _greedy_rollout(env, args, state.actor.device,
                              lambda s: alg.greedy_action(env, state.actor, s[:env.obs_dim],
                                                          cfg.hidden))
    return _emit_play_outputs(env, args, *rollout)


def recurrent_config(args) -> recurrent.RecurrentPpoConfig:
    """``--network=gru``'s config: hidden = embed = ``--num_hidden``, the
    rest from the PPO flags, as the JAX package's ``train_recurrent``."""
    return recurrent.RecurrentPpoConfig(
        num_envs=args.num_env, rollout_len=args.rollout_len, hidden=args.num_hidden,
        embed=args.num_hidden, learning_rate=args.lr, gamma=args.gamma, lam=args.lam,
        clip_eps=args.clip, entropy_coef=args.ent_coef)


def train_recurrent(args) -> recurrent.RecurrentTrainState:
    """The ``--network=gru`` loop: calls of ``train_many`` of
    ``--updates_per_jit`` updates each, a checkpoint every
    ``--save_interval`` calls and at the end."""
    env = make(args.env)
    cfg = recurrent_config(args)
    k = max(1, args.updates_per_jit)
    state = recurrent.init_train_state(env, cfg, args.seed, device=_device(args))
    if args.load_path:
        state = ckpt.restore(args.load_path, state)
    steps_per_update = cfg.num_envs * cfg.rollout_len
    num_updates = max(1, int(args.num_timesteps) // steps_per_update)
    logger = MetricsLogger(log_dir=args.log_dir, config=vars(args))
    last_t, last_update, update = time.perf_counter(), 0, 0
    while update < num_updates:
        state, metrics = recurrent.train_many(env, cfg, state, k)
        update += k
        if (update // k) % args.log_interval == 0 or update >= num_updates:
            host = to_host(metrics)  # waits for the device
            now = time.perf_counter()
            sps = steps_per_update * (update - last_update) / max(now - last_t, 1e-9)
            last_t, last_update = now, update
            logger.log(update, {"env_steps": steps_per_update * update,
                                "steps_per_sec": round(sps), **host})
        if args.save_path and (update // k) % args.save_interval == 0:
            _save_replica(args.save_path, state)
    if args.save_path:
        _save_replica(args.save_path, state)
    logger.close()
    return state


def recurrent_play_policy(env, cfg, state):
    """``(policy, observe)`` for :func:`_greedy_rollout`: the GRU policy's
    mean action with its hidden carried from call to call, and the mask
    set after each episode's end (done or truncated), as the JAX package's
    play loop sets it."""
    tree = recurrent.GruLayout.of(env, cfg).unflatten(state.params)
    device = state.params.device
    carry = {"h": torch.zeros((cfg.hidden, 1), device=device),
             "d": torch.zeros(1, device=device)}

    def policy(s):
        a, carry["h"] = recurrent.greedy_action(env, tree, carry["h"],
                                                s[:env.obs_dim].to(torch.float32), carry["d"])
        return a.to(s.dtype)

    def observe(out):
        ended = bool(out.done) or (out.truncated is not None and bool(out.truncated))
        carry["d"] = torch.full((1,), float(ended), device=device)

    return policy, observe


def play_recurrent(args, state=None):
    """``--play`` for ``--network=gru``: the mean action of the GRU policy,
    its hidden carried through the loop and masked after each episode's
    end (done or truncated), as the JAX package's play loop does (training
    masks on done only)."""
    env = make(args.env)
    cfg = recurrent_config(args)
    if state is None:
        state = recurrent.init_train_state(env, cfg, args.seed, device=_device(args))
        if args.load_path:
            state = ckpt.restore(args.load_path, state)
    if not distributed.is_main():
        return None
    device = state.params.device
    return _emit_play_outputs(env, args, *_greedy_rollout(env, args, device,
                                                          *recurrent_play_policy(env, cfg, state)))


def main(argv=None):
    args = build_parser().parse_args(argv)
    refuse_missing_renderer(args)
    if args.alg in OFF_POLICY:
        train_fn, play_fn = train_offpolicy, play_offpolicy
    elif args.network == "gru":
        if args.alg != "ppo":
            raise SystemExit("--network=gru supports --alg=ppo only")
        train_fn, play_fn = train_recurrent, play_recurrent
    else:
        train_fn = lambda a: train(a, mesh)  # noqa: E731
        play_fn = lambda a, s: play(a, s, mesh)  # noqa: E731
    mesh = setup_mesh(args)
    state = None
    if not args.play or args.load_path is None:
        state = train_fn(args)
    if args.play:
        play_fn(args, state)


if __name__ == "__main__":
    main()
