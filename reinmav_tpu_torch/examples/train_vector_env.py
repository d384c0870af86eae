"""Train through the ``gymnasium.vector.VectorEnv`` adapter with an
external-library-style loop: a NumPy policy, the standard ``reset`` /
``step`` vector API, nothing of the port's internals; the counterpart of
the JAX package's ``examples/train_vector_env.py``.

It shows the role the reference filled with baselines' ``make_vec_env``
and ppo2 (``gym_reinmav/run.py:73-94``): a third-party RL library that can
drive a gymnasium VectorEnv gets the batched stepping on the card.  The
learner is a deliberately tiny vanilla policy gradient (REINFORCE with a
linear value baseline) in NumPy; the real learner is ``python -m
reinmav_tpu_torch.rl.run``.

Run:  python -m reinmav_tpu_torch.examples.train_vector_env [--device=cpu] [--quick]
(needs gymnasium)
"""

from __future__ import annotations

import numpy as np

from . import parser, require


def train(venv, horizon: int, iters: int, lr: float, seed: int) -> list:
    """The REINFORCE loop on ``venv``; returns each iteration's mean
    reward."""
    obs_dim = venv.single_observation_space.shape[0]
    act_dim = venv.single_action_space.shape[0]
    rng = np.random.default_rng(seed)
    # Linear-Gaussian policy and linear value baseline.
    w = 0.01 * rng.standard_normal((obs_dim, act_dim))
    b = np.zeros(act_dim)
    log_std = np.full(act_dim, -0.5)
    vw = np.zeros(obs_dim)

    obs, _ = venv.reset(seed=seed)
    history = []
    for it in range(iters):
        obs_buf, act_buf, rew_buf, done_buf = [], [], [], []
        for _ in range(horizon):
            mean = obs @ w + b
            act = mean + np.exp(log_std) * rng.standard_normal(mean.shape)
            nobs, rew, term, trunc, _ = venv.step(act.astype(np.float32))
            obs_buf.append(obs)
            act_buf.append(act)
            rew_buf.append(rew)
            done_buf.append(term | trunc)
            obs = nobs
        o, a, r, d = (np.stack(x) for x in (obs_buf, act_buf, rew_buf, done_buf))

        # Reward-to-go with done masking; the linear value baseline.
        g = np.zeros_like(r)
        run = np.zeros(r.shape[1])
        for t in range(r.shape[0] - 1, -1, -1):
            run = r[t] + 0.99 * run * (1.0 - d[t])
            g[t] = run
        v = o @ vw
        adv = g - v
        adv = (adv - adv.mean()) / (adv.std() + 1e-8)

        # REINFORCE gradient of the linear-Gaussian policy.
        z = (a - (o @ w + b)) / np.exp(log_std)
        gw = np.einsum("tnd,tna->da", o, z * adv[..., None]) / z[..., 0].size
        gb = (z * adv[..., None]).mean((0, 1))
        w += lr * gw / np.exp(log_std)
        b += lr * gb / np.exp(log_std)
        vw += 1e-3 * np.einsum("tnd,tn->d", o, (g - v)) / g.size  # one LMS step

        history.append(float(r.mean()))
        print(f"iter {it:3d}  mean_reward {history[-1]:+.3f}  episodes_ended {int(d.sum())}")
    return history


def main(argv=None):
    p = parser(__doc__.splitlines()[0])
    p.add_argument("--num_envs", type=int, default=512)
    p.add_argument("--horizon", type=int, default=64)
    p.add_argument("--iters", type=int, default=30)
    p.add_argument("--lr", type=float, default=0.05)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    require("gymnasium", "train_vector_env", "the VectorEnv loop")
    from ..compat import vector_env

    if args.quick:
        args.num_envs, args.horizon, args.iters = 64, 16, 3
    venv = vector_env.make_vec("quadrotor3d-v0", args.num_envs, device=args.device)
    return train(venv, args.horizon, args.iters, args.lr, args.seed)


if __name__ == "__main__":
    main()
