"""Planar quadrotor (``quadrotor2d-v0``) in PyTorch.

The counterpart of :mod:`reinmav_tpu.envs.quadrotor2d`: 5-state ``[x, z,
theta, vx, vz]``, action ``[thrust_cmd, omega]``.  ``step`` and
``control`` work on the trailing axis, for one env ``(5,)`` or a batch
``(B, 5)``.

Behavioural parity points (see the JAX module for the reference lines):

* 10x thrust scaling floored at zero (PARITY.md Q5).
* Position-first explicit Euler with the old velocity (Q3).
* Done ``‖pos‖>pos_limit ∨ ‖vel‖>10 ∨ ‖vel‖>vel_limit``: the hard-coded
  10 is the reference's folded predicate (Q1/Q2) and survives a
  ``vel_limit`` sweep.
* Reward ``−‖pos‖`` while alive, ``+1`` on the done step.
* The controller's ``+9.8`` lift is the reference's constant, not
  ``−gravity``; its thrust is in Newtons and ``step`` applies the 10x
  gain, so the closed loop flies with that implicit gain.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..controllers import pd2d
from . import core
from .core import EnvDef, StepOut, uniform_reset


class Params(NamedTuple):
    mass: float = 1.0
    dt: float = 0.01
    gravity: float = -9.8
    ref_x: float = 0.0
    ref_z: float = 0.0
    pos_limit: float = 3.0
    vel_limit: float = 2.0
    kp: float = -5.0
    kv: float = -4.0
    tau: float = 0.1
    thrust_scale: float = 10.0


def params_from_jax(p) -> Params:
    """The JAX package's ``quadrotor2d.Params`` (or a mapping of its
    fields) as the port's :class:`Params` (:func:`core.params_from_jax`)."""
    return core.params_from_jax(Params, p)


def heading(att: torch.Tensor) -> torch.Tensor:
    """The body "up" direction ``(cos, sin)(att + pi/2)``, ``(..., 2)``."""
    return torch.stack([torch.cos(att + math.pi / 2), torch.sin(att + math.pi / 2)], dim=-1)


def step(p: Params, s: torch.Tensor, a: torch.Tensor) -> StepOut:
    dt = p.dt
    thrust = torch.clamp(p.thrust_scale * a[..., 0:1], min=0.0)
    w = a[..., 1]
    pos, att, vel = s[..., 0:2], s[..., 2], s[..., 3:5]

    g = s.new_tensor([0.0, p.gravity])
    acc = thrust / p.mass * heading(att) + g

    pos = pos + vel * dt + 0.5 * acc * dt * dt  # old velocity (Q3)
    vel = vel + acc * dt
    att = att + w * dt

    state = torch.cat([pos, att[..., None], vel], dim=-1)
    pn = torch.linalg.vector_norm(pos, dim=-1)
    vn = torch.linalg.vector_norm(vel, dim=-1)
    done = (pn > p.pos_limit) | (vn > 10.0) | (vn > p.vel_limit)
    reward = torch.where(done, torch.ones_like(pn), -pn)
    return StepOut(state, state, reward, done)


def pd_control(p, s: torch.Tensor) -> torch.Tensor:
    """The planar PD controller (:func:`reinmav_tpu_torch.controllers.pd2d.control`)
    on the quad part ``[x, z, theta, vx, vz]`` of ``s``, at the gains of
    ``p`` (``mass, ref_x, ref_z, kp, kv, tau``) and the reference's 9.8
    lift: the 2D envs' shared controller."""
    return pd2d.control(pd2d.Gains(kp=p.kp, kv=p.kv, tau=p.tau, mass=p.mass), s[..., 0:2],
                        s[..., 2], s[..., 3:5], s.new_tensor([p.ref_x, p.ref_z]))


def control(p: Params, s: torch.Tensor) -> torch.Tensor:
    """The reference controller (``quadrotor2d.py:115-138``): thrust in
    Newtons, which ``step`` scales by ``thrust_scale`` (Q5)."""
    return pd_control(p, s)


#: Module-level reset, so that a wrapped or customised env is detectable
#: by identity (``core.fused_kernel_mismatch``).
reset = uniform_reset(5)


def make(params: Params | None = None) -> EnvDef:
    return EnvDef(
        name="quadrotor2d-v0",
        state_dim=5,
        action_dim=2,
        obs_dim=5,
        params=params or Params(),
        step_fn=step,
        reset_fn=reset,
        control_fn=control,
    )
