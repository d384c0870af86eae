"""Functional env wrappers: ``EnvDef -> EnvDef`` transforms.

The counterpart of :mod:`reinmav_tpu.envs.wrappers` (the reference's
empty ``gym_reinmav/wrapper/`` package, whose intended occupant was an
``ActionClipWrapper``):

* :func:`clip_action`: clip actions into the action space (or given
  bounds) before stepping.
* :func:`scale_reward`: baselines' ``reward_scale`` knob.
* :func:`time_limit`: bounded-horizon truncation, the step counter
  carried as one extra state component.

A wrapped env replaces the registry's functions, so the fused kernels
refuse it by identity (``core.fused_kernel_mismatch``) and it runs on
the eager paths.
"""

from __future__ import annotations

import dataclasses

import torch

from .core import EnvDef, StepOut


def clip_action(env: EnvDef, low: float | None = None, high: float | None = None) -> EnvDef:
    """Clip actions into [low, high] (defaults: the env's action space)."""
    lo = env.action_low if low is None else low
    hi = env.action_high if high is None else high
    inner = env.step_fn

    def step_fn(params, state, action):
        return inner(params, state, torch.clamp(action, lo, hi))

    return dataclasses.replace(env, step_fn=step_fn)


def scale_reward(env: EnvDef, scale: float) -> EnvDef:
    inner = env.step_fn

    def step_fn(params, state, action):
        out = inner(params, state, action)
        return out._replace(reward=out.reward * scale)

    return dataclasses.replace(env, step_fn=step_fn)


def time_limit(env: EnvDef, max_steps: int) -> EnvDef:
    """Truncate after ``max_steps`` steps.  Appends a step counter to the
    state vector (``state_dim + 1``); ``obs_dim`` is unchanged.

    Horizon expiry is reported in ``StepOut.truncated``, not folded into
    ``done``: termination stays the inner env's verdict.  Auto-reset
    resets on ``done | truncated`` (``core.episode_boundary``).
    """
    inner_step = env.step_fn
    inner_reset = env.reset_fn

    def step_fn(params, state, action):
        count = state[..., -1]
        out = inner_step(params, state[..., :-1], action)
        count = count + 1.0
        truncated = (count >= max_steps) & ~out.done
        if out.truncated is not None:  # compose with an inner truncator
            truncated = truncated | out.truncated
        new_state = torch.cat([out.state, count[..., None].to(out.state.dtype)], dim=-1)
        return StepOut(new_state, out.obs, out.reward, out.done, truncated)

    def reset_fn(params, generator, batch, device, dtype):
        s = inner_reset(params, generator, batch, device, dtype)
        return torch.cat([s, s.new_zeros((batch, 1))], dim=-1)

    return dataclasses.replace(env, state_dim=env.state_dim + 1, step_fn=step_fn,
                               reset_fn=reset_fn)
