"""Functional environment engine of the PyTorch port.

The counterpart of :mod:`reinmav_tpu.envs.core`.  An environment is a
set of plain functions on tensors over a flat float state vector

    ``step(params, state, action) -> StepOut``
    ``reset(params, generator, batch, device, dtype) -> (batch, D) states``
    ``control(params, state) -> action``       (classical controller)

``step`` and ``control`` work on the trailing axis, so one function
serves a single env ``(D,)`` and a batch ``(B, D)``: the JAX package's
``vmap`` becomes a batch dimension written out.  Randomness comes from
an explicit ``torch.Generator`` in place of a PRNG key; the generator
lives on the device the states live on.

Rollouts are Python loops over the horizon.  The public layout is
``(B, D)``; the ``_t`` forms take the kernel layout ``(D, B)``.
:func:`throughput_rollout` runs a hand-written CUDA kernel when the
states lie on the card and the env is the registry's own: the
quadrotor3d closed loop (K1, :mod:`reinmav_tpu_torch.ops.rollout`), the
closed loops of quadrotor2d-v0 (K8) and the slung-load envs (K9,
:mod:`reinmav_tpu_torch.ops.closed_loop_rollout`), the hover task's
zero-action rollout (K5, :mod:`reinmav_tpu_torch.ops.hover_rollout`),
reinmav-v0's simulation (K10, :mod:`reinmav_tpu_torch.ops.reinmav_rollout`)
or the contact envs' zero-action rollout (K11,
:mod:`reinmav_tpu_torch.ops.contact_rollout`).
:func:`chunked_throughput_rollout` splits a long horizon into calls of
:func:`throughput_rollout` sized to a time budget.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from collections.abc import Mapping
from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch

log = logging.getLogger(__name__)


class StepOut(NamedTuple):
    """Result of one environment transition.

    ``done`` is termination; ``truncated`` (set only by time-limit
    wrappers) is horizon truncation, ``None`` for an env that never
    truncates.  :func:`episode_boundary` combines the two.
    """

    state: torch.Tensor
    obs: torch.Tensor
    reward: torch.Tensor
    done: torch.Tensor
    truncated: Optional[torch.Tensor] = None


def episode_boundary(out: StepOut) -> torch.Tensor:
    """Episode-end mask: terminated OR truncated."""
    return out.done if out.truncated is None else out.done | out.truncated


@dataclasses.dataclass(frozen=True)
class EnvDef:
    """Static definition of a functional environment.

    ``params`` is a NamedTuple of physical constants; the callables are
    plain functions (see the module docstring for their signatures).
    The action and observation bounds mirror the reference's gym spaces;
    ``action_low_phys``/``action_high_phys`` are the dynamically
    reachable action box (PARITY.md Q11).
    """

    name: str
    state_dim: int
    action_dim: int
    obs_dim: int
    params: Any
    step_fn: Callable[[Any, torch.Tensor, torch.Tensor], StepOut]
    reset_fn: Callable[..., torch.Tensor]
    control_fn: Optional[Callable[[Any, torch.Tensor], torch.Tensor]] = None
    action_low: float = -10.0
    action_high: float = 10.0
    obs_low: float = -10.0
    obs_high: float = 10.0
    action_low_phys: Optional[tuple] = None
    action_high_phys: Optional[tuple] = None
    #: True when ``reset_fn`` ignores its generator: the tpuquad family
    #: resets to the XML keyframe (``mujoco_quad.py:65-69``), so every
    #: reset cohort starts from the same state.
    deterministic_reset: bool = False

    def _require_control(self):
        if self.control_fn is None:
            raise NotImplementedError(f"{self.name} has no classical controller")

    # -- single env, (D,) ----------------------------------------------------
    def step(self, state, action) -> StepOut:
        return self.step_fn(self.params, state, action)

    def reset(self, generator: torch.Generator, dtype=torch.float32) -> torch.Tensor:
        return self.vreset(generator, 1, dtype=dtype)[0]

    def control(self, state) -> torch.Tensor:
        self._require_control()
        return self.control_fn(self.params, state)

    # -- batched, (B, D) -------------------------------------------------------
    def vstep(self, states, actions) -> StepOut:
        return self.step_fn(self.params, states, actions)

    def vreset(self, generator: torch.Generator, batch: int, device=None,
               dtype=torch.float32) -> torch.Tensor:
        """``batch`` fresh states, ``(batch, D)``, on ``device`` (default:
        the generator's device)."""
        device = generator.device if device is None else torch.device(device)
        return self.reset_fn(self.params, generator, batch, device, dtype)

    def vcontrol(self, states) -> torch.Tensor:
        self._require_control()
        return self.control_fn(self.params, states)

    def autoreset_step(self, states, actions, generator) -> StepOut:
        """Batched step with fused auto-reset: done envs are re-drawn from
        ``reset_fn``; their obs/reward/done describe the terminal
        transition."""
        out = self.vstep(states, actions)
        fresh = self.vreset(generator, states.shape[0], device=states.device,
                            dtype=out.state.dtype)
        boundary = episode_boundary(out)
        return out._replace(state=torch.where(boundary[:, None], fresh, out.state))

    # -- batched, (D, B) -------------------------------------------------------
    def vstep_t(self, states_t, actions_t) -> StepOut:
        """Step in the kernel layout: states/obs/actions ``(D, B)``,
        reward/done ``(B,)``."""
        out = self.vstep(states_t.T, actions_t.T)
        return out._replace(state=out.state.T, obs=out.obs.T)

    def vreset_t(self, generator, batch: int, device=None, dtype=torch.float32):
        return self.vreset(generator, batch, device=device, dtype=dtype).T

    def vcontrol_t(self, states_t) -> torch.Tensor:
        return self.vcontrol(states_t.T).T

    def autoreset_step_t(self, states_t, actions_t, generator) -> StepOut:
        out = self.autoreset_step(states_t.T, actions_t.T, generator)
        return out._replace(state=out.state.T, obs=out.obs.T)


def _stack(outs: list[StepOut]) -> StepOut:
    """List of per-step outputs → one ``StepOut`` with a leading time axis."""
    trunc = [o.truncated for o in outs]
    return StepOut(
        torch.stack([o.state for o in outs]),
        torch.stack([o.obs for o in outs]),
        torch.stack([o.reward for o in outs]),
        torch.stack([o.done for o in outs]),
        None if trunc[0] is None else torch.stack(trunc),
    )


def rollout(env: EnvDef, policy_fn: Callable[[torch.Tensor, torch.Generator], torch.Tensor],
            init_states: torch.Tensor, generator: torch.Generator, horizon: int,
            auto_reset: bool = True, collect_trajectory: bool = True):
    """Closed-loop batched rollout as a Python loop.

    ``policy_fn(states, generator) -> actions`` receives the FULL state
    ``(B, state_dim)`` (classical controllers read state beyond the
    observation).  Returns the final states and the stacked trajectory
    ``StepOut`` with a leading time axis ``(T, B, ...)``.  With
    ``collect_trajectory=False`` only rewards and dones are stacked;
    ``state`` and ``obs`` are then None.
    """
    states = init_states
    outs = []
    for _ in range(horizon):
        actions = policy_fn(states, generator)
        if auto_reset:
            out = env.autoreset_step(states, actions, generator)
        else:
            out = env.vstep(states, actions)
        outs.append(out if collect_trajectory else out._replace(state=None, obs=None))
        states = out.state
    if collect_trajectory:
        return states, _stack(outs)
    return states, StepOut(None, None, torch.stack([o.reward for o in outs]),
                           torch.stack([o.done for o in outs]))


def controller_policy(env: EnvDef):
    """The env's classical controller as a :func:`rollout` policy."""

    def policy(states, generator):
        del generator
        return env.vcontrol(states)

    return policy


def control_rollout(env: EnvDef, init_states, generator, horizon: int, auto_reset: bool = True,
                    collect_trajectory: bool = True):
    """Rollout flown by the env's own classical controller (the reference
    test pattern).  With ``collect_trajectory=False`` only rewards and
    dones are stacked; the returned ``StepOut`` then has ``state`` and
    ``obs`` set to None."""
    env._require_control()
    return rollout(env, controller_policy(env), init_states, generator, horizon,
                   auto_reset=auto_reset, collect_trajectory=collect_trajectory)


def _fused_kernel_registry():
    """name -> (step_fn, control_fn or None, reset_fn, default Params) that
    the env's fused kernel computes: K1 for quadrotor3d-v0, K8 for
    quadrotor2d-v0, K9 for the slung-load envs, K5 for the hover task, K10
    for reinmav-v0, K11 for MujocoQuadForce-v0 and MujocoQuadQuat-v0 (and
    K2/K6/K7, the policy-driven kernels, for the first five of them).  The
    kernels take the env's Params values as arguments, so a param sweep
    runs in them; params of another type do not.  ``control_fn`` None: the
    kernel has no classical controller (K5 and K11 step zero actions,
    K10's env takes none)."""
    from . import (quadrotor2d, quadrotor2d_slungload, quadrotor3d, quadrotor3d_slungload,
                   reinmav13, tpuquad)

    return {
        "quadrotor3d-v0": (quadrotor3d.step, quadrotor3d.control, quadrotor3d.reset,
                           quadrotor3d.Params()),
        "quadrotor2d-v0": (quadrotor2d.step, quadrotor2d.control, quadrotor2d.reset,
                           quadrotor2d.Params()),
        "quadrotor2d-slungload-v0": (quadrotor2d_slungload.step, quadrotor2d_slungload.control,
                                     quadrotor2d_slungload.reset, quadrotor2d_slungload.Params()),
        "quadrotor3d-slungload-v0": (quadrotor3d_slungload.step, quadrotor3d_slungload.control,
                                     quadrotor3d_slungload.reset, quadrotor3d_slungload.Params()),
        "MujocoQuadForce-v1": (tpuquad.hovering_step, None, tpuquad.hovering_reset,
                               tpuquad.Params(init_z=1.0)),
        "reinmav-v0": (reinmav13.step, None, reinmav13.reset, reinmav13.Params()),
        "MujocoQuadForce-v0": (tpuquad.force_step, None, tpuquad.force_reset, tpuquad.Params()),
        "MujocoQuadQuat-v0": (tpuquad.quat_step, None, tpuquad.quat_reset, tpuquad.QuatParams()),
    }


#: The envs of K11, the contact rollout.
_CONTACT_ENVS = ("MujocoQuadForce-v0", "MujocoQuadQuat-v0")


def fused_kernel_mismatch(env: EnvDef, require_control: bool = True,
                          packed_params: bool = True):
    """Why a fused kernel would NOT reproduce ``env``'s semantics (None =
    eligible).  The kernels compute the registry's module FUNCTIONS, so
    a wrapped env (same name, replaced fns) is refused by identity, and
    so are params of another type.  A deterministic reset (the tpuquad
    family's ``det_reset_init_z`` tag) is accepted when its ``init_z`` is
    the env's ``Params.init_z``, which the kernels read: a non-default
    ``init_z`` makes a new reset closure, not the registry's object.
    ``require_control=False`` skips the controller's identity (the
    policy-driven kernels, K2, replace the controller with the policy).
    ``packed_params=True`` (every kernel of the port so far): the caller
    passes the live Params to the kernel as arguments, so any values are
    accepted, but a value the kernel cannot honour (the contact envs'
    ``contact_enabled=False``) is refused; ``False`` refuses non-default
    values rather than run them with the defaults."""
    entry = _fused_kernel_registry().get(env.name)
    if entry is None:
        return f"no fused kernel for {env.name}"
    step_fn, control_fn, reset_fn, default_params = entry
    if getattr(reset_fn, "det_reset_init_z", None) is not None:
        reset_ok = (getattr(env.reset_fn, "det_reset_init_z", None)
                    == float(getattr(env.params, "init_z", float("nan"))))
    else:
        reset_ok = env.reset_fn is reset_fn
    fns_ok = env.step_fn is step_fn and reset_ok
    if require_control and control_fn is not None:
        fns_ok = fns_ok and env.control_fn is control_fn
    if not fns_ok:
        return "env step/control/reset fns are wrapped or replaced"
    if type(env.params) is not type(default_params):
        return f"env params are a {type(env.params).__name__}, not the kernel's Params"
    if not getattr(env.params, "contact_enabled", True) and env.name in _CONTACT_ENVS:
        return "contact_enabled=False, and K11 always solves the contact"
    if not packed_params and env.params != default_params:
        return "non-default params, and the caller does not pass them to the kernel"
    return None


def _kernel_refusal(env: EnvDef, init_states: torch.Tensor):
    """Why :func:`throughput_rollout` cannot run ``env`` in its fused
    kernel (None = it can): the registry check, then the device."""
    reason = fused_kernel_mismatch(env)
    if reason is not None:
        return reason
    if init_states.device.type != "cuda":
        return f"states on {init_states.device}, the kernel needs a CUDA tensor"
    return None


def throughput_rollout(env: EnvDef, init_states, generator, horizon: int,
                       backend: str = "auto"):
    """Maximum-rate closed-loop rollout with auto-reset: returns only
    ``(final_states (B, D), per-env reward sums (B,))``.

    An env with a classical controller is flown by it; an env without one
    (the tpuquad family) is stepped with zero actions; reinmav-v0, which
    takes no action and whose done is always True, is stepped without
    auto-reset.  ``backend``: ``"kernel"`` runs the env's fused CUDA
    kernel (float32, the registry's functions, any params: K1 for
    quadrotor3d-v0, K8 for quadrotor2d-v0, K9 for the slung-load envs, K5
    for MujocoQuadForce-v1, K10 for reinmav-v0, K11 for MujocoQuadForce-v0
    and MujocoQuadQuat-v0), one launch per call, and raises where it
    cannot; ``"scan"`` runs the eager loop; ``"auto"`` takes the kernel
    where it can and logs which path ran and why.  K1, K8 and K9 draw their
    reset states from their own Philox stream, seeded from ``generator``: a
    different stream from the eager loop's, deterministic per seed.  K5's
    and K11's resets are deterministic, as the envs'.  reinmav-v0's reward
    sums are ``90 * horizon``, the contact envs' 0, as their rewards (the
    kernel branches return ``90 * horizon + 0 * x`` and ``0 * Σz``, as the
    JAX kernel path's: NaN for an env whose state went non-finite).
    """
    if backend not in ("auto", "kernel", "scan"):
        raise ValueError(f"unknown backend {backend!r}")
    if backend == "auto":
        reason = _kernel_refusal(env, init_states)
        backend = "scan" if reason else "kernel"
        log.info("throughput_rollout(%s, B=%d): %s", env.name, init_states.shape[0],
                 f"eager loop ({reason})" if reason else "fused CUDA kernel")
    if backend == "kernel":
        reason = _kernel_refusal(env, init_states)
        if reason is not None:
            raise ValueError(f"kernel backend refused for {env.name}: {reason}")
        states_t = init_states.T.to(torch.float32).contiguous()
        if env.name == "reinmav-v0":
            from ..ops import reinmav_rollout as reinmav_ops

            final_t = reinmav_ops.reinmav_rollout(
                states_t, horizon, params_vec=reinmav_ops.reinmav_params_vec(env.params))
            # 90 a step, tied to the kernel's states as the JAX kernel path
            # ties it: NaN for an env whose state went non-finite.
            return final_t.T, 90.0 * horizon + 0.0 * final_t[0]
        if env.name in _CONTACT_ENVS:
            from ..ops import contact_rollout as contact_ops

            final_t, z_sum = contact_ops.contact_rollout(
                states_t, horizon, params_vec=contact_ops.contact_params_vec(env.params),
                frame_skip=env.params.frame_skip)
            # The envs' reward is identically 0; 0 * Σz, as the JAX path, so
            # that an env whose z went non-finite reports NaN, not 0.
            return final_t.T, 0.0 * z_sum
        if env.name == "MujocoQuadForce-v1":
            from ..ops import hover_rollout as hover_ops

            final_t, reward_sum = hover_ops.hover_rollout(
                states_t, horizon, params_vec=hover_ops.hover_params_vec(env.params),
                frame_skip=env.params.frame_skip)
            return final_t.T, reward_sum
        from ..ops import closed_loop_rollout as cl_ops
        from ..ops import rollout as rollout_ops

        seed = int(torch.randint(0, 2**31 - 1, (), generator=generator,
                                 device=generator.device))
        if env.name in cl_ops.KINDS:
            final_t, reward_sum = cl_ops.closed_loop_rollout(
                env.name, states_t, seed, horizon,
                params_vec=cl_ops.KINDS[env.name].pack(env.params))
            return final_t.T, reward_sum
        final_t, reward_sum = rollout_ops.quad3d_rollout_autoreset(
            states_t, seed, horizon, params_vec=rollout_ops.quad3d_params_vec(env.params))
        return final_t.T, reward_sum
    final, rewards = _eager_rollout(env, init_states, generator, horizon)
    return final, rewards.sum(dim=0)


def _eager_rollout(env: EnvDef, init_states, generator, horizon: int):
    """The eager loop of :func:`throughput_rollout`: ``(final states, the
    (T, B) rewards)``.  An env with a controller is flown by it with fused
    auto-reset; one without is stepped with zero actions, with fused
    auto-reset, except reinmav-v0: a continuous simulation whose done is
    always True (PARITY.md Q9), which auto-resetting would re-init every
    step, so it steps plainly, as the JAX package's loop and K10 do."""
    if env.control_fn is not None:
        final, traj = control_rollout(env, init_states, generator, horizon,
                                      collect_trajectory=False)
        return final, traj.reward

    def zero_policy(states, generator):
        del generator
        return states.new_zeros((states.shape[0], env.action_dim))

    final, traj = rollout(env, zero_policy, init_states, generator, horizon,
                          auto_reset=env.name != "reinmav-v0", collect_trajectory=False)
    return final, traj.reward


def chunked_throughput_rollout(env: EnvDef, init_states, generator, horizon: int,
                               backend: str = "auto", device_time_budget_s: float = 30.0,
                               probe_steps: int = 8):
    """:func:`throughput_rollout` in several calls of at most about
    ``device_time_budget_s`` each, carrying the states, the reward sums and
    ``generator`` (its own continuation) from one to the next.  Returns
    ``(final_states (B, D), per-env reward sums (B,))``.

    A long horizon then never makes one launch of unbounded length: the
    reference loops ``mj_step`` on the host, so any horizon works there
    (``gym_reinmav/example/mujoco/control_rpy.py:58-79``).  Mechanics, as
    the JAX package's: a ``probe_steps`` call (it absorbs a kernel's build
    at first use), a second one timed, waiting for the device (the per-step
    time), then chunks sized to the budget, quantised to powers of two,
    each chunk's time refining the estimate.

    The eager backend (``"scan"``, or ``"auto"`` where no kernel runs) is
    bit for bit the unchunked call with the same generator: the loop's
    draws continue across chunks, and the reward sums are taken once over
    every step's rewards, as the unchunked loop takes them (which holds
    ``(T, B)`` rewards, as that loop does).  On the kernel backend each
    chunk is one launch of the env's kernel, and K1, K8 and K9 draw a
    fresh seed for each from ``generator``: the chunks are distinct
    streams, deterministic per seed.

    It launches from the host, so it refuses to run during CUDA graph
    capture (the JAX function refuses under ``jit``): call
    :func:`throughput_rollout` there, with a horizon sized by the caller.
    """
    if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
        raise ValueError("chunked_throughput_rollout launches from the host and cannot run "
                         "during CUDA graph capture: use throughput_rollout with a horizon "
                         "sized by the caller")
    horizon = int(horizon)
    if horizon <= 0:
        raise ValueError(f"horizon must be positive, got {horizon}")
    if probe_steps <= 0:
        raise ValueError(f"probe_steps must be positive, got {probe_steps}")
    if backend not in ("auto", "kernel", "scan"):
        raise ValueError(f"unknown backend {backend!r}")
    if backend == "auto":
        reason = _kernel_refusal(env, init_states)
        backend = "scan" if reason else "kernel"
        log.info("chunked_throughput_rollout(%s, B=%d): %s", env.name, init_states.shape[0],
                 f"eager loop ({reason})" if reason else "fused CUDA kernel")
    cuda = init_states.device.type == "cuda"

    def run(states, steps):
        """One chunk and its wall time, the device waited for."""
        if cuda:
            torch.cuda.synchronize(init_states.device)
        t0 = time.perf_counter()
        if backend == "scan":
            out = _eager_rollout(env, states, generator, steps)
        else:
            out = throughput_rollout(env, states, generator, steps, backend="kernel")
        if cuda:
            torch.cuda.synchronize(init_states.device)
        return out, time.perf_counter() - t0

    states, parts, lengths = init_states, [], []
    remaining, per_step = horizon, None
    while remaining > 0:
        if len(lengths) < 2 or per_step is None or per_step <= 0:
            steps = min(remaining, probe_steps)
        else:
            target = max(1, int(device_time_budget_s / per_step))
            steps = min(remaining, 1 << (target.bit_length() - 1))
        (states, part), seconds = run(states, steps)
        parts.append(part)
        lengths.append(steps)
        remaining -= steps
        if len(lengths) >= 2:  # the first call may include a kernel's build
            per_step = seconds / steps
    log.info("chunked_throughput_rollout(%s): %d chunks of %s steps", env.name, len(lengths),
             lengths)
    if backend == "scan":
        return states, torch.cat(parts).sum(dim=0)
    total = parts[0]
    for part in parts[1:]:
        total = total + part
    return states, total


def params_from_jax(params_type, p):
    """The JAX package's flat-float ``Params`` of an env (or a mapping of
    its fields, values as floats or NumPy scalars) as the port's
    ``params_type``.  Raises ``ValueError`` if the fields or their order
    differ."""
    fields = tuple(p.keys()) if isinstance(p, Mapping) else getattr(type(p), "_fields", None)
    if fields != params_type._fields:
        raise ValueError(f"params fields {fields} != {params_type._fields}")
    values = p.values() if isinstance(p, Mapping) else p
    return params_type(*(float(np.asarray(v)) for v in values))


def uniform_reset(dim: int, low: float = -1.0, high: float = 1.0):
    """Reference-style reset: every state component ~ U(low, high),
    including the unnormalised quaternion."""

    def reset_fn(params, generator, batch, device, dtype):
        del params
        u = torch.rand((batch, dim), generator=generator, device=device, dtype=dtype)
        return u * (high - low) + low

    return reset_fn
