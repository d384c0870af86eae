"""Cascaded RPY PID controller as a plain function with an explicit carry.

The counterpart of :mod:`reinmav_tpu.controllers.rpy_pid`, the
reference's ``RpyController`` (``gym_reinmav/controller/
rpy_pid_controller.py:88-191``): an outer x/y PD gives the desired roll
and pitch through a body-frame rotation, an inner [z, roll, pitch, yaw]
PID with a finite-difference derivative and an integrator, the gravity
feed-forward ``-m g / (cos(phi) cos(theta))``, and the 4 x 4 mixer
mapping [u_z, u_roll, u_pitch, u_yaw] to the motor forces.  The error
buffers are the explicit :class:`PidCarry`.  Works on the trailing axis,
so a batch is a leading dimension of every argument and of the carry.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops import quadmath as qm


class Gains(NamedTuple):
    """PID gains (the reference's ``AttitudeControlGain`` and
    ``PositionControlGain``) and the mixer's constants."""

    kp_zrpy: tuple = (2.0, 0.1, 0.1, 0.3)
    kd_zrpy: tuple = (0.5, 0.1, 0.1, 0.1)
    ki_zrpy: tuple = (0.01, 0.01, 0.01, 0.01)
    kp_xy: tuple = (0.6, 0.6)
    kd_xy: tuple = (0.2, 0.2)
    motor_c: float = 0.1
    motor_l: float = 0.1


class PidCarry(NamedTuple):
    """Error buffers of the cascaded PID (finite difference + integrator)."""

    position_error: torch.Tensor  # (..., 2)
    zrpy_error: torch.Tensor      # (..., 4)
    zrpy_error_int: torch.Tensor  # (..., 4)


def init_carry(dtype=torch.float32, device=None, batch_shape=()) -> PidCarry:
    """Zero buffers, with ``batch_shape`` leading."""
    kw = dict(dtype=dtype, device=device)
    return PidCarry(torch.zeros((*batch_shape, 2), **kw), torch.zeros((*batch_shape, 4), **kw),
                    torch.zeros((*batch_shape, 4), **kw))


def mixer_matrix(g: Gains, dtype=torch.float32, device=None) -> torch.Tensor:
    """C_R of the reference's ``MotorParam``: rows are the motors (++, +-,
    --, -+); a = 1/4, b = 1/(4L), c = 1/(4C)."""
    a, b, c = 0.25, 1.0 / (4.0 * g.motor_l), 1.0 / (4.0 * g.motor_c)
    return torch.tensor([[a, b, -b, -c], [a, -b, -b, c], [a, -b, b, -c], [a, b, b, c]],
                        dtype=dtype, device=device)


def control(gains: Gains, carry: PidCarry, position: torch.Tensor, quat: torch.Tensor,
            position_d: torch.Tensor, yaw_d, dt, mass, gravity=-9.81):
    """One evaluation -> ``(motor forces (..., 4), new carry)``.

    The JAX function's order: desired roll = -(R_BW u_s)[1], desired pitch
    = +(R_BW u_s)[0] with ``R_BW = inv(quat_to_rotmat(quat))`` of the RAW
    quaternion (the reference inverts the unit-quaternion formula applied
    to the raw elements), and the gravity feed-forward divided by
    cos(phi) cos(theta).
    """
    rpy = qm.quat_to_rpy(quat)
    position_d = torch.as_tensor(position_d, dtype=position.dtype, device=position.device)
    yaw_d = torch.as_tensor(yaw_d, dtype=position.dtype, device=position.device)
    x_state = torch.cat([position[..., 2:3], rpy], dim=-1)  # [z, roll, pitch, yaw]

    # Outer position PD with a finite-difference derivative.
    es = position_d[..., 0:2] - position[..., 0:2]
    es_dot = (es - carry.position_error) / dt
    us = position.new_tensor(gains.kp_xy) * es + position.new_tensor(gains.kd_xy) * es_dot
    us3 = torch.cat([us, torch.zeros_like(us[..., :1])], dim=-1)

    rot_bw = torch.linalg.inv(qm.quat_to_rotmat(quat))
    us_b = (rot_bw @ us3[..., None])[..., 0]
    batch = us_b.shape[:-1]
    x_d = torch.stack([position_d[..., 2].expand(batch), -us_b[..., 1], us_b[..., 0],
                       yaw_d.expand(batch)], dim=-1)

    # Inner z/r/p/y PID.
    ex = x_d - x_state
    ex_dot = (ex - carry.zrpy_error) / dt
    ex_int = carry.zrpy_error_int + ex * dt
    u = (position.new_tensor(gains.kp_zrpy) * ex + position.new_tensor(gains.kd_zrpy) * ex_dot
         + position.new_tensor(gains.ki_zrpy) * ex_int)
    gravity_ff = -mass * gravity / (torch.cos(rpy[..., 1]) * torch.cos(rpy[..., 0]))
    u = torch.cat([u[..., :1] + gravity_ff[..., None], u[..., 1:]], dim=-1)

    forces = (mixer_matrix(gains, position.dtype, position.device) @ u[..., None])[..., 0]
    return forces, PidCarry(es, ex, ex_int)
