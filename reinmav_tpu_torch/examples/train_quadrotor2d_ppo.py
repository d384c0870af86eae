"""PPO on quadrotor2d-v0, then a greedy play: the stable-baselines recipe
of the reference (``examples/train_quadrotor2d_ppo2.py``: PPO2 with an
MLP policy, 3e5 steps, then a play rollout); the counterpart of the JAX
package's ``examples/train_quadrotor2d_ppo.py``.  On the card each update
is one launch of K6 (the fused rollout) and one of K4 (the update).

Run:  python -m reinmav_tpu_torch.examples.train_quadrotor2d_ppo [--device=cpu] [--quick]
"""

from __future__ import annotations

import torch

from .. import make
from ..rl import networks, ppo
from . import parser

ENV = "quadrotor2d-v0"
#: (num_envs, rollout_len, total env steps, play steps): the JAX example's,
#: and the reduced size.
FULL, QUICK = (512, 64, 300_000, 1000), (64, 16, 2048, 100)


def train(num_envs: int, rollout_len: int, total_steps: int, device="cuda"):
    """PPO from seed 0; returns ``(state, per-update mean_reward)``."""
    env = make(ENV)
    cfg = ppo.PpoConfig(num_envs=num_envs, rollout_len=rollout_len, hidden=(64, 64))
    step = ppo.make_train_step(env, cfg)
    state = ppo.init_train_state(env, cfg, 0, device=device)
    rewards = []
    for update in range(max(1, total_steps // (num_envs * rollout_len))):
        state, metrics = step(state)
        rewards.append(float(metrics["mean_reward"]))
        print(f"update {update}: mean_reward={rewards[-1]:.4f}")
    return state, rewards


@torch.no_grad()
def play(state: ppo.TrainState, steps: int) -> float:
    """The greedy policy (its mean action) on one env for ``steps`` steps,
    reset on each episode's end; returns the total reward."""
    env = make(ENV)
    device = state.params.device
    tree = networks.Layout(env.obs_dim, env.action_dim, (64, 64)).unflatten(state.params)
    s = env.reset(torch.Generator(device=device).manual_seed(1))
    reset = torch.Generator(device=device).manual_seed(2)
    total = 0.0
    for _ in range(steps):
        norm = ppo._normalize_t(s[:env.obs_dim, None], state.obs_norm)
        mean, _, _ = networks.apply_t(tree, norm)
        out = env.step(s, mean[:, 0])
        total += float(out.reward)
        s = env.reset(reset) if bool(out.done) else out.state
    return total


def main(argv=None):
    args = parser(__doc__.splitlines()[0]).parse_args(argv)
    num_envs, rollout_len, total_steps, play_steps = QUICK if args.quick else FULL
    state, rewards = train(num_envs, rollout_len, total_steps, args.device)
    ret = play(state, play_steps)
    print("play return:", ret)
    return rewards, ret


if __name__ == "__main__":
    main()
