"""Train/play CLI of the PyTorch port: the PPO family of
:mod:`reinmav_tpu.rl.run`, on one CUDA device.

Usage (the JAX package's flags; ``--device`` is the port's own)::

    python -m reinmav_tpu_torch.rl.run --alg=ppo --env=quadrotor3d-v0 \\
        --num_timesteps=1e7 --num_env=32768 --rollout_len=32 --save_path=./models/quad3d
    python -m reinmav_tpu_torch.rl.run --play --load_path=./models/quad3d \\
        --num_env=32768 --rollout_len=32

``--alg`` ``ppo``, ``a2c`` (one epoch, one batch, no ratio clipping) and
``ppo_kl`` (the adaptive-KL penalty).  On the card every update is one
K2 launch for the rollout and one K4 launch for the update
(:func:`reinmav_tpu_torch.rl.ppo.train_step` logs which paths ran).
``--device=cpu`` runs the same loop on the CPU, through the kernels'
plain twins.  What is not ported yet exits with a message naming its
ROADMAP.md item: ``--alg`` ``sac``/``td3``/``ddpg``, ``--network=gru``,
``--shard_map``, ``--compute_dtype=bfloat16``, and the renderers
``--gif``/``--html``/``--live``.  ``--no_mesh`` is accepted and changes
nothing (one device).
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from .. import make
from ..utils import checkpoint as ckpt
from ..utils.metrics import MetricsLogger, to_host
from . import evaluate, networks, ppo

#: Flag values that are not ported yet -> the ROADMAP.md item that ports them.
_NOT_PORTED = {
    "alg": ({"sac", "td3", "ddpg"}, "the off-policy learners (ROADMAP.md queue 1 item 10)"),
    "network": ({"gru"}, "the GRU learner (ROADMAP.md queue 1 item 12)"),
    "compute_dtype": ({"bfloat16"}, "bf16 matmul inputs (ROADMAP.md queue 1 item 5)"),
}
_NOT_PORTED_FLAGS = {
    "shard_map": "the shard_map train step (ROADMAP.md queue 1 item 13)",
    "gif": "the renderers (ROADMAP.md queue 1 item 7); they stay in reinmav_tpu",
    "html": "the renderers (ROADMAP.md queue 1 item 7); they stay in reinmav_tpu",
    "live": "the live viewer (ROADMAP.md queue 1 item 7); it stays in reinmav_tpu",
}


def build_parser() -> argparse.ArgumentParser:
    # The JAX package's flag names and defaults (reinmav_tpu/rl/run.py).
    p = argparse.ArgumentParser(description="PyTorch + CUDA PPO training for reinmav envs")
    p.add_argument("--env", default="quadrotor3d-v0")
    p.add_argument("--alg", default="ppo", choices=["ppo", "a2c", "ppo_kl", "sac", "td3", "ddpg"],
                   help="a2c = one epoch, one batch, no ratio clipping; ppo_kl = the "
                        "adaptive-KL penalty (beta adapted to --kl_target).  sac, td3 and ddpg "
                        "are not ported yet")
    p.add_argument("--network", default="mlp", choices=["mlp", "gru"],
                   help="gru is not ported yet")
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
    p.add_argument("--num_hidden", type=int, default=64)
    p.add_argument("--compute_dtype", default="float32", choices=("float32", "bfloat16"),
                   help="bfloat16 is not ported yet")
    p.add_argument("--ent_coef", type=float, default=0.0)
    p.add_argument("--log_std_floor", type=float, default=None,
                   help="lower clamp on the policy log-std after each optimiser step")
    p.add_argument("--save_path", default=None)
    p.add_argument("--load_path", default=None)
    p.add_argument("--save_interval", type=int, default=50)
    p.add_argument("--log_interval", type=int, default=10)
    p.add_argument("--updates_per_jit", type=int, default=1,
                   help="updates per train_many call between metric reads")
    p.add_argument("--log_dir", default=None)
    p.add_argument("--eval_interval", type=int, default=0,
                   help="greedy-policy evaluation every N logged updates (0=off)")
    p.add_argument("--eval_envs", type=int, default=256)
    p.add_argument("--eval_horizon", type=int, default=1000)
    p.add_argument("--play", action="store_true")
    p.add_argument("--play_steps", type=int, default=1000)
    p.add_argument("--live", action="store_true", help="not ported yet")
    p.add_argument("--gif", default=None, help="not ported yet")
    p.add_argument("--html", default=None, help="not ported yet")
    p.add_argument("--no_mesh", action="store_true", help="accepted; one device, no mesh")
    p.add_argument("--shard_map", action="store_true", help="not ported yet")
    p.add_argument("--device", default="cuda",
                   help="torch device to train on (the port's own flag; cpu runs the plain twins)")
    return p


def refuse_not_ported(args) -> None:
    """Exit with a message naming the ROADMAP.md item of each flag value
    that is not ported yet."""
    for flag, (values, what) in _NOT_PORTED.items():
        if getattr(args, flag) in values:
            raise SystemExit(f"--{flag}={getattr(args, flag)} is not ported to PyTorch yet: {what}")
    for flag, what in _NOT_PORTED_FLAGS.items():
        if getattr(args, flag):
            raise SystemExit(f"--{flag} is not ported to PyTorch yet: {what}")


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


def _eval_generator(args, update: int) -> torch.Generator:
    """The evaluation's own stream, so that evaluating leaves training's
    generator untouched."""
    return torch.Generator(device=args.device).manual_seed(args.seed * 1_000_003 + update)


def train(args) -> ppo.TrainState:
    env = make(args.env)
    cfg = make_config(args)
    k = max(1, args.updates_per_jit)
    state = ppo.init_train_state(env, cfg, args.seed, device=args.device)
    if args.load_path:
        state = ckpt.restore(args.load_path, state)

    steps_per_update = cfg.num_envs * cfg.rollout_len
    num_updates = max(1, int(args.num_timesteps) // steps_per_update)
    logger = MetricsLogger(log_dir=args.log_dir, config=vars(args))
    last_t, last_update, update = time.perf_counter(), 0, 0
    while update < num_updates:
        state, metrics = ppo.train_many(env, cfg, state, k)
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
        if args.eval_interval and (update // k) % args.eval_interval == 0:
            stats = evaluate.evaluate(env, state.params,
                                      state.obs_norm if cfg.normalize_obs else None,
                                      _eval_generator(args, update), num_envs=args.eval_envs,
                                      horizon=args.eval_horizon, hidden=cfg.hidden)
            logger.log(update, {"eval_mean_return": stats.mean_return,
                                "eval_mean_length": stats.mean_length,
                                "eval_episodes": stats.num_episodes,
                                "eval_running_return": stats.mean_running_return,
                                "eval_survival_frac": stats.survival_frac})
        if args.save_path and (update // k) % args.save_interval == 0:
            ckpt.save(args.save_path, state)
    if args.save_path:
        ckpt.save(args.save_path, state)
    logger.close()
    return state


@torch.no_grad()
def play(args, state: ppo.TrainState | None = None):
    """Deterministic greedy rollout of one env with the trained policy,
    resetting on each episode's end; prints one JSON line and returns the
    ``(play_steps, obs_dim)`` observations."""
    env = make(args.env)
    cfg = make_config(args)
    if state is None:
        # The restore target mirrors the training shapes (num_env and
        # rollout_len size the checkpoint's env states).
        state = ppo.init_train_state(env, cfg, args.seed, device=args.device)
        if args.load_path:
            state = ckpt.restore(args.load_path, state)
    tree = networks.Layout(env.obs_dim, env.action_dim, cfg.hidden).unflatten(state.params)
    device = state.params.device

    def reset(seed):
        return env.reset(torch.Generator(device=device).manual_seed(seed))

    s = reset(args.seed + 1)
    total_reward, episodes, obs = 0.0, 0, []
    for t in range(args.play_steps):
        norm = ppo._normalize_t(s[:env.obs_dim, None], state.obs_norm)
        mean, _, _ = networks.apply_t(tree, norm)
        out = env.step(s, mean[:, 0])
        total_reward += float(out.reward)
        obs.append(out.obs)
        truncated = out.truncated is not None and bool(out.truncated)
        if bool(out.done) or truncated:
            episodes += 1
            s = reset(args.seed + 3 + t)
        else:
            s = out.state
    print(json.dumps({"play_steps": args.play_steps, "episodes": episodes,
                      "total_reward": round(total_reward, 3)}))
    return torch.stack(obs).cpu() if obs else torch.empty((0, env.obs_dim))


def main(argv=None):
    args = build_parser().parse_args(argv)
    refuse_not_ported(args)
    state = None
    if not args.play or args.load_path is None:
        state = train(args)
    if args.play:
        play(args, state)


if __name__ == "__main__":
    main()
