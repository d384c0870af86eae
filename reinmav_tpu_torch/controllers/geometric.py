"""Geometric (quaternion, tilt-prioritised) controller as a plain function.

The counterpart of :mod:`reinmav_tpu.controllers.geometric`: the
controller the reference embeds in ``Quadrotor3D.control``,
``Quadrotor3DSlungload.control`` and its MuJoCo demo, once, parameterised
by the reference position, velocity and acceleration and the gains.  The
env ``control_fn``\\ s keep their own copies bound to the env params.
Works on the trailing axis: ``pos``/``vel``/``ref_*`` ``(..., 3)``,
``quat`` ``(..., 4)``, so a batch is a leading dimension.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops import quadmath as qm


class Gains(NamedTuple):
    kp: tuple = (-5.0, -5.0, -5.0)
    kv: tuple = (-4.0, -4.0, -4.0)
    tau: float = 0.3
    gravity: float = -9.8


def control(gains: Gains, pos: torch.Tensor, quat: torch.Tensor, vel: torch.Tensor,
            ref_pos: torch.Tensor, ref_vel: torch.Tensor | None = None,
            ref_acc: torch.Tensor | None = None) -> torch.Tensor:
    """-> action ``[thrust, wx, wy, wz]``, ``(..., 4)``.

    The JAX function's order: the attitude error from the *raw*
    quaternion, the thrust projection from the normalised one;
    ``sign(qe0)`` is 0 at a 180 degree error (PARITY.md Q10).
    """
    kp, kv = pos.new_tensor(gains.kp), pos.new_tensor(gains.kv)
    g = pos.new_tensor([0.0, 0.0, gains.gravity])
    if ref_vel is None:
        ref_vel = torch.zeros_like(vel)
    feedback = kp * (pos - ref_pos) + kv * (vel - ref_vel)
    desired_acc = (ref_acc if ref_acc is not None else 0.0) + feedback - g

    desired_quat = qm.acc2quat(desired_acc)
    qe = qm.quat_mul(qm.quat_conj(quat), desired_quat)
    w = (2.0 / gains.tau) * torch.sign(qe[..., :1]) * qe[..., 1:4]

    rot = qm.quat_to_rotmat(qm.quat_normalize(quat))
    thrust = (desired_acc * rot[..., :, 2]).sum(dim=-1)
    return torch.cat([thrust[..., None], w], dim=-1)


def circle_reference(t, radius: float = 0.5, omega: float = 1.0, z: float = 1.0,
                     dtype=torch.float32, device=None) -> torch.Tensor:
    """The MuJoCo demos' circle (``control_quat.py:140-146``,
    ``control_rpy.py:66-72``): ``(..., 3)`` positions at times ``t``."""
    t = torch.as_tensor(t, dtype=dtype, device=device)
    x = radius * torch.cos(omega * t)
    y = radius * torch.sin(omega * t)
    return torch.stack([x, y, z * torch.ones_like(x)], dim=-1)
