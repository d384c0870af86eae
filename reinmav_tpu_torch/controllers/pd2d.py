"""Planar PD position + attitude-rate controller as a plain function.

The counterpart of :mod:`reinmav_tpu.controllers.pd2d`: the math of the
2D envs' ``control()`` (reference ``quadrotor2d.py:115-138`` and
``quadrotor2d_slungload.py:160-186``), factored out for standalone use
(a custom reference trajectory, say).  The env ``control_fn``\\ s keep
their own copies bound to the env params.  Works on the trailing axis:
``pos``/``vel`` ``(..., 2)``, ``att`` ``(...)``.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch


class Gains(NamedTuple):
    kp: float = -5.0
    kv: float = -4.0
    tau: float = 0.1
    mass: float = 1.0
    lift: float = 9.8  # gravity-compensation feed-forward


def control(gains: Gains, pos: torch.Tensor, att: torch.Tensor, vel: torch.Tensor,
            ref_pos: torch.Tensor, ref_vel: torch.Tensor | None = None) -> torch.Tensor:
    """-> action ``[thrust_N, omega]`` (thrust in Newtons; the plain 2D env
    then applies its implicit 10x gain in ``step``, Q5)."""
    if ref_vel is None:
        ref_vel = torch.zeros_like(vel)
    lift = pos.new_tensor([0.0, gains.lift])
    desired_acc = gains.kp * (pos - ref_pos) + gains.kv * (vel - ref_vel) + lift
    desired_att = torch.atan2(desired_acc[..., 1], desired_acc[..., 0]) - math.pi / 2
    w = (-1.0 / gains.tau) * (att - desired_att)
    thrust = gains.mass * torch.linalg.vector_norm(desired_acc, dim=-1)
    return torch.stack([thrust, w], dim=-1)
