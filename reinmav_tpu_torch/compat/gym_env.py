"""Gymnasium single-env adapter of the PyTorch port.

The counterpart of :mod:`reinmav_tpu.compat.gym_env`: a functional
:class:`reinmav_tpu_torch.EnvDef` as a ``gymnasium.Env`` with the
``reset()/step()`` object API, registered under ``reinmav_tpu_torch/<id>``
for the eight env ids (the reference's gym registrations,
``gym_reinmav/__init__.py:3-41``).  One state in and out per call: for
debugging and third-party tooling, not the throughput path (use the
batched rollouts or :class:`reinmav_tpu_torch.compat.vector_env.VectorGymAdapter`).

* The gymnasium 5-tuple ``(obs, reward, terminated, truncated, info)``;
  horizon truncation from a ``time_limit`` wrapper is ``truncated``.
* ``reset(options={"state": s})`` starts from a given state.
* ``control()``: the env's classical controller action from the internal
  state (the reference's non-standard env method, ``quadrotor3d.py:126``).
* ``params`` overrides the env's physical constants, ``wrappers`` are
  ``EnvDef -> EnvDef`` transforms (:mod:`reinmav_tpu_torch.envs.wrappers`).

The state stays a float32 tensor on the adapter's ``device`` (the card
unless the caller passes ``device="cpu"``); NumPy appears only in what
the gym API returns.  The env's randomness is a ``torch.Generator`` on
that device, seeded by ``reset(seed=...)``.  :func:`single_step` is the
adapter's work a step, without gymnasium.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

try:
    import gymnasium
    from gymnasium import spaces
except ImportError:  # pragma: no cover - gymnasium is an optional extra
    gymnasium = None
    spaces = None

from ..envs.registry import make as make_funcenv

#: The port's own gymnasium namespace (the JAX package registers under
#: ``reinmav_tpu/``, so the two never take each other's ids).
PREFIX = "reinmav_tpu_torch/"


def make_env(env_id: str, params=None, wrappers=()):
    """The registry's env (``env_id`` with or without :data:`PREFIX`),
    with ``params`` and then each of ``wrappers`` applied."""
    env = make_funcenv(env_id.removeprefix(PREFIX),
                       **({"params": params} if params is not None else {}))
    for wrap in wrappers:
        env = wrap(env)
    return env


def single_step(env, state, action):
    """One step of ``state`` with the NumPy ``action`` on the state's
    device: ``(new state, obs float32 NumPy, reward, terminated,
    truncated)``."""
    action = torch.as_tensor(np.asarray(action, np.float32), device=state.device)
    out = env.step(state, action)
    truncated = bool(out.truncated) if out.truncated is not None else False
    return (out.state, out.obs.detach().to("cpu", torch.float32).numpy(), float(out.reward),
            bool(out.done), truncated)


def box(low, high, dim: int):
    return spaces.Box(low=low, high=high, shape=(dim,), dtype=np.float32)


class GymAdapter(gymnasium.Env if gymnasium else object):
    metadata = {"render_modes": ["rgb_array"]}

    def __init__(self, env_id: str, render_mode: Optional[str] = None, params=None,
                 wrappers=(), device="cuda"):
        if gymnasium is None:
            raise ImportError("gymnasium is required for the compat adapter")
        # `is not None`: a params NamedTuple of zeros is a real override.
        self.env = make_env(env_id, params, wrappers)
        self.render_mode = render_mode
        self.device = torch.device(device)
        self._generator = torch.Generator(device=self.device).manual_seed(0)
        self._state = None
        self._history = []
        # reinmav-v0 takes no action (action_dim 0); its space keeps one entry.
        self.action_space = box(self.env.action_low, self.env.action_high,
                                max(self.env.action_dim, 1))
        self.observation_space = box(self.env.obs_low, self.env.obs_high, self.env.obs_dim)

    def _obs(self, obs: torch.Tensor) -> np.ndarray:
        return obs.detach().to("cpu", torch.float32).numpy()

    def reset(self, *, seed: Optional[int] = None, options=None):
        # Gymnasium's protocol: a seeded reset also seeds np_random (the env
        # checker asserts it); the env's own draws come from the generator.
        super().reset(seed=seed)
        if seed is not None:
            self._generator.manual_seed(seed)
        if options and "state" in options:
            self._state = torch.as_tensor(np.asarray(options["state"], np.float32),
                                          device=self.device)
        else:
            self._state = self.env.reset(self._generator)
        obs = self._obs(self._state[:self.env.obs_dim])
        self._history = [obs]
        return obs, {}

    def step(self, action):
        self._state, obs, reward, terminated, truncated = single_step(self.env, self._state,
                                                                      action)
        self._history.append(obs)
        return obs, reward, terminated, truncated, {}

    def control(self) -> np.ndarray:
        """The classical controller's action from the current internal
        state (the reference's non-standard env method)."""
        return self._obs(self.env.control(self._state))

    def render(self):
        if self.render_mode == "rgb_array":
            from ..render.plot import render_frame

            return render_frame(self.env.name, self._state)
        return None

    def plot_state(self, path_prefix: str = "trajectory"):
        """Offline trajectory plots of the episode so far (the reference's
        ``plot_state``, ``reinmav_env.py:138-185``)."""
        from ..render.plot import plot_trajectory

        return plot_trajectory(self.env.name, np.stack(self._history), path_prefix)

    def render_html(self, path: str = "trajectory.html", **kwargs) -> str:
        """A self-contained browser animation of the episode so far (the
        vpython canvas's role, ``quadrotor3d.py:187-307``, recorded)."""
        from ..render.html_view import save_html

        return save_html(self.env.name, np.stack(self._history), path, **kwargs)


def register_all() -> None:
    """Register every env id with gymnasium under :data:`PREFIX`; an id
    already registered is left as it is."""
    if gymnasium is None:
        return
    from ..envs.registry import registered_ids

    for env_id in registered_ids():
        full = PREFIX + env_id
        if full not in gymnasium.registry:
            gymnasium.register(id=full, entry_point=GymAdapter, kwargs={"env_id": env_id})


def make(env_id: str, **kwargs) -> GymAdapter:
    return GymAdapter(env_id.removeprefix(PREFIX), **kwargs)
