"""3D quadrotor (``quadrotor3d-v0``), the flagship env, in PyTorch.

The counterpart of :mod:`reinmav_tpu.envs.quadrotor3d`: 10-state
``[pos(3), quat wxyz(4), vel(3)]``, action ``[thrust, wx, wy, wz]``
(body rates).  ``step`` and ``control`` work on the trailing axis, for
one env ``(10,)`` or a batch ``(B, 10)``.

Behavioural parity points (see the JAX module for the reference lines):

* Acceleration ``(T/m)·R(q̂)·ẑ + g`` with ``q̂`` the normalised
  quaternion; the stored quaternion stays unnormalised (PARITY.md Q4).
* Position-first Euler with the old velocity.
* ``q += dt·½ q̂⊗(0,ω)``.
* Done: ``‖pos‖>pos_limit ∨ ‖vel‖>vel_limit``; reward ``−‖pos‖``
  alive, ``+1`` on the done step.
* Geometric controller: Gram-Schmidt ``acc2quat``, attitude error from
  the *unnormalised* quaternion, ``sign(0) = 0`` (PARITY.md Q10).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops import quadmath as qm
from . import core
from .core import EnvDef, StepOut, uniform_reset


class Params(NamedTuple):
    mass: float = 1.0
    dt: float = 0.01
    gravity: float = -9.8
    ref_x: float = 0.0
    ref_y: float = 0.0
    ref_z: float = 2.0
    pos_limit: float = 3.0
    vel_limit: float = 10.0
    kp: float = -5.0
    kv: float = -4.0
    tau: float = 0.3


def params_from_jax(p) -> Params:
    """The JAX package's ``quadrotor3d.Params`` (or a mapping of its
    fields) as the port's :class:`Params` (:func:`core.params_from_jax`)."""
    return core.params_from_jax(Params, p)


def step(p: Params, s: torch.Tensor, a: torch.Tensor) -> StepOut:
    dt = p.dt
    thrust = a[..., 0:1]
    w = a[..., 1:4]
    pos, att, vel = s[..., 0:3], s[..., 3:7], s[..., 7:10]

    g = s.new_tensor([0.0, 0.0, p.gravity])
    qn = qm.quat_normalize(att)
    rot = qm.quat_to_rotmat(qn)
    acc = thrust / p.mass * rot[..., :, 2] + g  # R·ẑ is the third column

    pos = pos + vel * dt + 0.5 * acc * dt * dt  # old velocity (Q3)
    vel = vel + acc * dt
    att = att + qm.quat_derivative(qn, w) * dt  # stored quat stays unnormalised

    state = torch.cat([pos, att, vel], dim=-1)
    pn = torch.linalg.vector_norm(pos, dim=-1)
    vn = torch.linalg.vector_norm(vel, dim=-1)
    done = (pn > p.pos_limit) | (vn > p.vel_limit)
    reward = torch.where(done, torch.ones_like(pn), -pn)
    return StepOut(state, state, reward, done)


def control(p: Params, s: torch.Tensor) -> torch.Tensor:
    """Geometric / tilt-prioritised attitude controller.  The attitude
    error uses the raw current quaternion, the thrust projection the
    normalised one."""
    pos, att, vel = s[..., 0:3], s[..., 3:7], s[..., 7:10]
    ref_pos = s.new_tensor([p.ref_x, p.ref_y, p.ref_z])
    g = s.new_tensor([0.0, 0.0, p.gravity])

    desired_acc = p.kp * (pos - ref_pos) + p.kv * vel - g
    desired_quat = qm.acc2quat(desired_acc)

    qe = qm.quat_mul(qm.quat_conj(att), desired_quat)  # raw quat (no normalise)
    w = (2.0 / p.tau) * torch.sign(qe[..., 0:1]) * qe[..., 1:4]

    rot = qm.quat_to_rotmat(qm.quat_normalize(att))
    thrust = (desired_acc * rot[..., :, 2]).sum(dim=-1, keepdim=True)
    return torch.cat([thrust, w], dim=-1)


#: Module-level reset, so that a wrapped or customised env is detectable
#: by identity (``core.fused_kernel_mismatch``).
reset = uniform_reset(10)


def make(params: Params | None = None) -> EnvDef:
    return EnvDef(
        name="quadrotor3d-v0",
        state_dim=10,
        action_dim=4,
        obs_dim=10,
        params=params or Params(),
        step_fn=step,
        reset_fn=reset,
        control_fn=control,
        action_low=0.0,
        action_high=10.0,
        # Q11: the declared Box(0,10)^4 forbids the negative body rates the
        # controller commands; this is the dynamically reachable box.
        action_low_phys=(0.0, -10.0, -10.0, -10.0),
        action_high_phys=(19.6, 10.0, 10.0, 10.0),
    )
