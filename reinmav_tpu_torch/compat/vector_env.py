"""Gymnasium ``VectorEnv`` adapter over the port's batched env step.

The counterpart of :mod:`reinmav_tpu.compat.vector_env`.  The reference
trained through baselines' subprocess vector envs
(``gym_reinmav/run.py:73-94``); this adapter keeps that interface, one
object stepping N sub-envs with auto-reset, but the N sub-envs are one
batch of tensors stepped by :meth:`EnvDef.autoreset_step` on the
adapter's device (the card unless the caller passes ``device="cpu"``).

Semantics: gymnasium 1.x ``AutoresetMode.SAME_STEP``.  When a sub-env's
episode ends (terminated or truncated, ``core.episode_boundary``), the
returned observation is the NEW episode's first and the terminal one is
in ``infos["final_obs"]``, masked by ``infos["_final_obs"]``.  Rewards are
float64, as gymnasium's vector envs return them.

Each ``step`` is one batched step (dynamics, boundary, reset draws) on the
device and ONE copy of everything the API returns to the host:
:func:`batched_step`, which needs no gymnasium and is the whole of the
adapter's work a step.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

try:
    import gymnasium
    from gymnasium.vector import AutoresetMode, VectorEnv
    from gymnasium.vector.utils import batch_space
except ImportError:  # pragma: no cover - gymnasium is an optional extra
    gymnasium = None
    VectorEnv = object

from ..envs.core import EnvDef, episode_boundary
from .gym_env import box, make_env


def batched_step(env: EnvDef, states, actions, generator):
    """One batched auto-reset step of ``states`` ``(B, D)`` with NumPy
    ``actions``, on the states' device, and one copy to the host.  Returns
    ``(new states, next obs (post-reset), final obs, reward float64,
    terminated, truncated, boundary)``, all but the states as NumPy."""
    actions = torch.as_tensor(np.asarray(actions, np.float32), device=states.device)
    out = env.autoreset_step(states, actions, generator)
    d = env.obs_dim
    truncated = torch.zeros_like(out.done) if out.truncated is None else out.truncated
    flags = torch.stack([out.done, truncated, episode_boundary(out)], dim=1)
    # One device-to-host copy: [next obs | final obs | reward | terminated,
    # truncated, boundary].
    host = torch.cat([out.state[:, :d], out.obs, out.reward[:, None], flags.to(out.obs.dtype)],
                     dim=1).cpu().numpy()
    terminated, truncated, boundary = (host[:, 2 * d + 1:] != 0).T
    return (out.state, host[:, :d].astype(np.float32), host[:, d:2 * d],
            host[:, 2 * d].astype(np.float64), terminated, truncated, boundary)


class VectorGymAdapter(VectorEnv):
    """N batched sub-envs as one ``gymnasium.vector.VectorEnv``."""

    def __init__(self, env_id: str, num_envs: int, params=None, wrappers=(), device="cuda"):
        if gymnasium is None:
            raise ImportError("gymnasium is required for the compat adapter")
        self.metadata = {"autoreset_mode": AutoresetMode.SAME_STEP, "render_modes": []}
        self.env = make_env(env_id, params, wrappers)
        self.num_envs = int(num_envs)
        self.device = torch.device(device)
        self.spec = None
        self.render_mode = None
        self.single_action_space = box(self.env.action_low, self.env.action_high,
                                       max(self.env.action_dim, 1))
        self.single_observation_space = box(self.env.obs_low, self.env.obs_high,
                                            self.env.obs_dim)
        self.action_space = batch_space(self.single_action_space, self.num_envs)
        self.observation_space = batch_space(self.single_observation_space, self.num_envs)
        self._generator = torch.Generator(device=self.device).manual_seed(0)
        self._states = None

    def reset(self, *, seed: Optional[int] = None, options=None):
        if seed is not None:
            self._generator.manual_seed(seed)
        self._states = self.env.vreset(self._generator, self.num_envs)
        return self._states[:, :self.env.obs_dim].to("cpu", torch.float32).numpy(), {}

    def step(self, actions):
        if self._states is None:
            raise RuntimeError("call reset() before step()")
        (self._states, next_obs, final_obs, reward, terminated, truncated,
         boundary) = batched_step(self.env, self._states, actions, self._generator)
        infos = {}
        if boundary.any():
            # SAME_STEP: the terminal obs where an episode ended, and the mask.
            infos["final_obs"] = np.where(boundary[:, None], final_obs, np.nan).astype(np.float32)
            infos["_final_obs"] = boundary
        return next_obs, reward, terminated, truncated, infos

    def close_extras(self, **kwargs):
        pass

    @property
    def unwrapped(self):
        return self


def make_vec(env_id: str, num_envs: int, **kwargs) -> VectorGymAdapter:
    return VectorGymAdapter(env_id, num_envs, **kwargs)
