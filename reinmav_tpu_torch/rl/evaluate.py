"""Policy evaluation: batched deterministic (greedy-mean) rollouts with
episode accounting, of a PPO policy (:func:`evaluate`) or an off-policy
actor (:func:`evaluate_actor`).

The counterpart of :mod:`reinmav_tpu.rl.evaluate`: the same
:class:`EvalStats` and the same rule that a run with no completed
episode reports NaN (not 0) for the mean return and length.  The
rollout is an eager loop on the device of the states, with fused
auto-reset drawn from a ``torch.Generator`` on that device.  The draw of
the initial states (:func:`_initial_states`) is kept apart from the loop
(:func:`_rollout_stats`), so that a test can start both packages from
the same states.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from ..envs.core import EnvDef, episode_boundary
from . import networks, ppo


class EvalStats(NamedTuple):
    mean_return: torch.Tensor
    mean_length: torch.Tensor
    num_episodes: torch.Tensor
    mean_reward: torch.Tensor  # per-step average
    mean_running_return: torch.Tensor  # avg return of episodes still alive
    survival_frac: torch.Tensor  # fraction of envs alive the whole horizon


def evaluate(env: EnvDef, params: torch.Tensor, obs_norm: ppo.ObsNorm | None,
             generator: torch.Generator, num_envs: int = 256, horizon: int = 1000,
             hidden: Sequence[int] = (64, 64)) -> EvalStats:
    """Greedy-mean rollout of the PPO policy with flat ``params`` (see
    :func:`evaluate_policy`); ``obs_norm`` None skips the observation
    normalisation."""
    tree = networks.Layout(env.obs_dim, env.action_dim, hidden).unflatten(params)

    def policy(obs):
        obs_t = obs.T
        if obs_norm is not None:
            obs_t = ppo._normalize_t(obs_t, obs_norm)
        mean_t, _, _ = networks.apply_t(tree, obs_t)
        return mean_t.T

    return evaluate_policy(env, policy, generator, num_envs, horizon)


def evaluate_actor(env: EnvDef, learner, actor: torch.Tensor, hidden: Sequence[int],
                   generator: torch.Generator, num_envs: int = 256,
                   horizon: int = 1000) -> EvalStats:
    """Greedy rollout of an off-policy actor (see :func:`evaluate_policy`):
    ``learner`` the module that trained it (:mod:`.sac` or :mod:`.td3`),
    whose ``greedy_action`` maps observations to the noise-free action of
    the flat ``actor`` of widths ``hidden``."""
    return evaluate_policy(env, lambda obs: learner.greedy_action(env, actor, obs, hidden),
                           generator, num_envs, horizon)


def evaluate_policy(env: EnvDef, policy, generator: torch.Generator, num_envs: int = 256,
                    horizon: int = 1000) -> EvalStats:
    """Deterministic-policy rollout with episode statistics.

    ``policy``: ``(B, obs_dim)`` raw observations -> ``(B, action_dim)``
    actions.  ``generator`` (on the device the rollout runs on) draws the
    initial states and the auto-resets.  Episodes still running at the
    horizon are excluded from the return/length means."""
    return _rollout_stats(env, policy, _initial_states(env, generator, num_envs), generator,
                          horizon)


def _initial_states(env: EnvDef, generator: torch.Generator, num_envs: int) -> torch.Tensor:
    return env.vreset(generator, num_envs)


@torch.no_grad()
def _rollout_stats(env: EnvDef, policy, states: torch.Tensor, generator: torch.Generator,
                   horizon: int) -> EvalStats:
    """The evaluation loop from the given ``(B, D)`` initial states."""
    dtype, dev = states.dtype, states.device
    num_envs = states.shape[0]
    ep_ret = torch.zeros(num_envs, dtype=dtype, device=dev)
    ep_len = torch.zeros(num_envs, dtype=torch.int32, device=dev)
    tot_ret = torch.zeros((), dtype=dtype, device=dev)
    tot_len = torch.zeros((), dtype=dtype, device=dev)
    n_eps = torch.zeros((), dtype=torch.int32, device=dev)
    reward_sum = torch.zeros((), dtype=dtype, device=dev)
    for _ in range(horizon):
        out = env.autoreset_step(states, policy(states[:, :env.obs_dim]), generator)
        # The boundary auto-reset uses (done | truncated).
        ended = episode_boundary(out)
        done_f = ended.to(dtype)
        ep_ret = ep_ret + out.reward
        ep_len = ep_len + 1
        tot_ret = tot_ret + torch.sum(ep_ret * done_f)
        tot_len = tot_len + torch.sum(ep_len * done_f)
        n_eps = n_eps + ended.sum().to(torch.int32)
        ep_ret = ep_ret * (1.0 - done_f)
        ep_len = ep_len * (1 - ended.to(torch.int32))
        reward_sum = reward_sum + out.reward.sum()
        states = out.state
    # No completed episode means "no data", not "return 0": NaN.
    nan = torch.full((), float("nan"), dtype=dtype, device=dev)
    safe_n = torch.clamp(n_eps, min=1)
    return EvalStats(
        mean_return=torch.where(n_eps == 0, nan, tot_ret / safe_n),
        mean_length=torch.where(n_eps == 0, nan, tot_len / safe_n),
        num_episodes=n_eps,
        mean_reward=reward_sum / (horizon * num_envs),
        mean_running_return=ep_ret.mean(),
        survival_frac=(ep_len == horizon).to(torch.float32).mean(),
    )
