"""3D quadrotor with a slung load (``quadrotor3d-slungload-v0``) in
PyTorch.

The counterpart of :mod:`reinmav_tpu.envs.quadrotor3d_slungload`:
16-state ``[pos(3), quat wxyz(4), vel(3), load_pos(3), load_vel(3)]``,
action ``[thrust, wx, wy, wz]``.  ``step`` and ``control`` work on the
trailing axis.

The taut/slack structure of the 2D slung-load env, but POSITION-first
Euler for load and quad (Q3, the opposite order of the 2D sibling).  The
quaternion follows quadrotor3d's semantics: normalised for the rotation
and its derivative, unnormalised in storage (Q4).  Done on the load's
position and the quad's velocity norms; reward ``−‖load_pos‖``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops import quadmath as qm
from . import core, quadrotor3d
from .core import EnvDef, StepOut, uniform_reset
from .quadrotor2d_slungload import dot, safe_unit


class Params(NamedTuple):
    mass: float = 1.0
    load_mass: float = 0.1
    dt: float = 0.01
    gravity: float = -9.8
    tether_length: float = 1.5
    pos_limit: float = 3.0
    vel_limit: float = 10.0
    ref_x: float = 0.0
    ref_y: float = 0.0
    ref_z: float = 1.0
    kp: float = -5.0
    kv: float = -4.0
    tau: float = 0.3


def params_from_jax(p) -> Params:
    """The JAX package's ``quadrotor3d_slungload.Params`` (or a mapping of
    its fields) as the port's :class:`Params`."""
    return core.params_from_jax(Params, p)


def step(p: Params, s: torch.Tensor, a: torch.Tensor) -> StepOut:
    dt = p.dt
    thrust, w = a[..., 0:1], a[..., 1:4]
    pos, att, vel = s[..., 0:3], s[..., 3:7], s[..., 7:10]
    load_pos, load_vel = s[..., 10:13], s[..., 13:16]

    g = s.new_tensor([0.0, 0.0, p.gravity])
    tether_vec = load_pos - pos
    tnorm = torch.linalg.vector_norm(tether_vec, dim=-1, keepdim=True)
    unit = safe_unit(tether_vec)
    taut = tnorm >= p.tether_length

    qn = qm.quat_normalize(att)
    body_z = qm.quat_to_rotmat(qn)[..., :, 2]  # R(q̂)·ẑ

    # ---- taut branch (position-first Euler) ----
    thrust_vec = thrust * body_z
    la_t = dot(unit, thrust_vec - p.mass * p.tether_length * dot(load_vel, load_vel)) * unit
    la_t = (1.0 / (p.mass + p.load_mass)) * la_t + g
    lp_t = load_pos + load_vel * dt + 0.5 * la_t * dt * dt  # old velocity
    lv_t = load_vel + la_t * dt

    tension = p.load_mass * torch.linalg.vector_norm(-g + la_t, dim=-1, keepdim=True) * unit
    acc_t = thrust / p.mass * body_z + g + tension / p.mass
    pos_t = pos + vel * dt + 0.5 * acc_t * dt * dt
    vel_t = vel + acc_t * dt

    load_dir = safe_unit(lp_t - pos_t)
    lp_t = pos_t + load_dir * p.tether_length
    lv_t = lv_t - dot(lv_t - vel_t, load_dir) * load_dir

    # ---- slack branch ----
    lp_s = load_pos + load_vel * dt + 0.5 * g * dt * dt
    lv_s = load_vel + g * dt
    acc_s = thrust / p.mass * body_z + g
    pos_s = pos + vel * dt + 0.5 * acc_s * dt * dt
    vel_s = vel + acc_s * dt

    # ---- select, and the quaternion update both branches share ----
    pos = torch.where(taut, pos_t, pos_s)
    vel = torch.where(taut, vel_t, vel_s)
    load_pos = torch.where(taut, lp_t, lp_s)
    load_vel = torch.where(taut, lv_t, lv_s)
    att = att + qm.quat_derivative(qn, w) * dt  # stored quat stays unnormalised

    state = torch.cat([pos, att, vel, load_pos, load_vel], dim=-1)
    lpn = torch.linalg.vector_norm(load_pos, dim=-1)
    vn = torch.linalg.vector_norm(vel, dim=-1)
    done = (lpn > p.pos_limit) | (vn > p.vel_limit)
    reward = torch.where(done, torch.ones_like(lpn), -lpn)
    return StepOut(state, state, reward, done)


def control(p: Params, s: torch.Tensor) -> torch.Tensor:
    """quadrotor3d's geometric controller on the quad state, its reference
    at z = 1 (reference ``quadrotor3d_slungload.py:169-226``)."""
    return quadrotor3d.control(p, s[..., 0:10])


#: Module-level reset, so that a wrapped or customised env is detectable
#: by identity (``core.fused_kernel_mismatch``).
reset = uniform_reset(16)


def make(params: Params | None = None) -> EnvDef:
    return EnvDef(
        name="quadrotor3d-slungload-v0",
        state_dim=16,
        action_dim=4,
        obs_dim=16,
        params=params or Params(),
        step_fn=step,
        reset_fn=reset,
        control_fn=control,
    )
