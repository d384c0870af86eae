"""Planar quadrotor with a slung load (``quadrotor2d-slungload-v0``) in
PyTorch.

The counterpart of :mod:`reinmav_tpu.envs.quadrotor2d_slungload`: 9-state
``[x, z, theta, vx, vz, lx, lz, lvx, lvz]``, action ``[thrust, w]``
(thrust in Newtons, no 10x gain here).  ``step`` and ``control`` work on
the trailing axis.

The taut and slack tether branches are both computed and then selected
per env.  Parity points (see the JAX module for the reference lines):

* The taut load acceleration projects ``thrust_vec − m·L·⟨lv,lv⟩`` (a
  scalar subtracted from every component, as the reference does) onto
  the tether, then adds gravity; tension ``T = m_l·‖−g+a_l‖·û``.
* Velocity-FIRST Euler for load and quad (Q3, the opposite of the 3D
  sibling).
* The kinematic projection of the load back onto the tether circle and
  the removal of its radial relative velocity (taut branch only).
* Done on the load's position and velocity norms; reward ``−‖quad pos‖``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import core
from .core import EnvDef, StepOut, uniform_reset
from .quadrotor2d import heading, pd_control


class Params(NamedTuple):
    mass: float = 1.0
    load_mass: float = 0.1
    dt: float = 0.01
    gravity: float = -9.8
    tether_length: float = 0.5
    pos_limit: float = 2.0
    vel_limit: float = 10.0
    ref_x: float = 0.0
    ref_z: float = 0.0
    kp: float = -5.0
    kv: float = -4.0
    tau: float = 0.1


def params_from_jax(p) -> Params:
    """The JAX package's ``quadrotor2d_slungload.Params`` (or a mapping of
    its fields) as the port's :class:`Params`."""
    return core.params_from_jax(Params, p)


def safe_unit(v: torch.Tensor) -> torch.Tensor:
    """``v / ‖v‖`` over the trailing axis, ``v`` itself where ``‖v‖ = 0``."""
    n = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    return v / torch.where(n > 0.0, n, torch.ones_like(n))


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a * b).sum(dim=-1, keepdim=True)


def step(p: Params, s: torch.Tensor, a: torch.Tensor) -> StepOut:
    dt = p.dt
    thrust, w = a[..., 0:1], a[..., 1]
    pos, att, vel = s[..., 0:2], s[..., 2], s[..., 3:5]
    load_pos, load_vel = s[..., 5:7], s[..., 7:9]

    g = s.new_tensor([0.0, p.gravity])
    head = heading(att)
    tether_vec = load_pos - pos
    tnorm = torch.linalg.vector_norm(tether_vec, dim=-1, keepdim=True)
    unit = safe_unit(tether_vec)  # the reference divides unguarded; unused when slack
    taut = tnorm >= p.tether_length

    # ---- taut branch ----
    thrust_vec = thrust * head
    la_t = dot(unit, thrust_vec - p.mass * p.tether_length * dot(load_vel, load_vel)) * unit
    la_t = (1.0 / (p.mass + p.load_mass)) * la_t + g
    lv_t = load_vel + la_t * dt  # velocity FIRST (Q3)
    lp_t = load_pos + lv_t * dt + 0.5 * la_t * dt * dt

    tension = p.load_mass * torch.linalg.vector_norm(-g + la_t, dim=-1, keepdim=True) * unit
    acc_t = thrust / p.mass * head + g + tension / p.mass
    vel_t = vel + acc_t * dt
    pos_t = pos + vel_t * dt + 0.5 * acc_t * dt * dt

    load_dir = safe_unit(lp_t - pos_t)
    lp_t = pos_t + load_dir * p.tether_length
    lv_t = lv_t - dot(lv_t - vel_t, load_dir) * load_dir

    # ---- slack branch ----
    lv_s = load_vel + g * dt
    lp_s = load_pos + lv_s * dt + 0.5 * g * dt * dt
    acc_s = thrust / p.mass * head + g
    vel_s = vel + acc_s * dt
    pos_s = pos + vel_s * dt + 0.5 * acc_s * dt * dt

    # ---- select ----
    pos = torch.where(taut, pos_t, pos_s)
    vel = torch.where(taut, vel_t, vel_s)
    load_pos = torch.where(taut, lp_t, lp_s)
    load_vel = torch.where(taut, lv_t, lv_s)
    att = att + w * dt  # the same in both branches

    state = torch.cat([pos, att[..., None], vel, load_pos, load_vel], dim=-1)
    lpn = torch.linalg.vector_norm(load_pos, dim=-1)
    lvn = torch.linalg.vector_norm(load_vel, dim=-1)
    done = (lpn > p.pos_limit) | (lvn > p.vel_limit)
    reward = torch.where(done, torch.ones_like(lpn), -torch.linalg.vector_norm(pos, dim=-1))
    return StepOut(state, state, reward, done)


def control(p: Params, s: torch.Tensor) -> torch.Tensor:
    """The plain 2D env's PD controller on the quad state, ignoring the
    load (reference ``quadrotor2d_slungload.py:160-186``)."""
    return pd_control(p, s)


#: Module-level reset, so that a wrapped or customised env is detectable
#: by identity (``core.fused_kernel_mismatch``).
reset = uniform_reset(9)


def make(params: Params | None = None) -> EnvDef:
    return EnvDef(
        name="quadrotor2d-slungload-v0",
        state_dim=9,
        action_dim=2,
        obs_dim=9,
        params=params or Params(),
        step_fn=step,
        reset_fn=reset,
        control_fn=control,
    )
