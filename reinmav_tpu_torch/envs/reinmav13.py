"""The 13-state controller-in-the-loop quadrotor (``reinmav-v0``) in PyTorch.

The counterpart of :mod:`reinmav_tpu.envs.reinmav13`: 13 states ``[pos(3),
vel(3), quat wxyz(4), body rates pqr(3)]`` plus the simulation time as a
14th component.  ``step`` works on the trailing axis, for one env
``(14,)`` or a batch ``(B, 14)``.

One outer step (``dt = 1/100``) runs the inner PD controller, the quintic
reference trajectory and the rigid-body equations of motion in an
explicit-Euler substep loop (``ds = 1/5000``): a masked loop of 51
iterations whose live count is ``ceil(((t + dt) - t) / ds)`` in the carry
dtype, the reference's ``len(np.arange(t, t + dt, ds))`` (50 or 51).

Parity quirks kept (PARITY.md Q9): ``step`` ignores the action, ``done``
is always True and the reward is 90; the motor mixer clamps the per-rotor
thrust to ``[min_force/4, max_force/4]`` and passes Mz through unclamped;
``q̇`` carries the ``K_quat = 2`` norm feedback.  ``reset`` returns the
documented init state at t = 0 (the reference's reset is a stale no-op).
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import NamedTuple

import numpy as np
import torch

from ..ops import quadmath as qm
from .core import EnvDef, StepOut


class Params(NamedTuple):
    mass: float = 0.18
    gravity: float = 9.81
    arm_length: float = 0.086
    min_force: float = 0.0
    max_force: float = 3.5316
    dt: float = 1.0 / 100.0
    ds: float = 1.0 / 5000.0
    # Inertia (reference reinmav_env.py:60-63), as rows.
    inertia: tuple = (
        (0.00025, 0.0, 2.55e-06),
        (0.0, 0.000232, 0.0),
        (2.55e-06, 0.0, 0.0003738),
    )
    kp: tuple = (10.0, 10.0, 35.0)
    kd: tuple = (5.0, 5.0, 22.0)
    kp_rot: tuple = (100.0, 100.0, 100.0)
    kd_rot: tuple = (0.1, 0.1, 0.1)
    t_max: float = 4.0
    k_quat: float = 2.0


STATE_DIM = 14  # 13 physical states + simulation time
INIT_STATE = (0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0)
#: Iterations of the masked substep loop (the most ``n_sub`` can be).
MAX_SUBSTEPS = 51


def params_from_jax(p) -> Params:
    """The JAX package's ``reinmav13.Params`` (or a mapping of its fields,
    values as Python or NumPy scalars and nested tuples) as the port's
    :class:`Params`.  Raises ``ValueError`` if the fields or their order
    differ."""
    fields = tuple(p.keys()) if isinstance(p, Mapping) else getattr(type(p), "_fields", None)
    if fields != Params._fields:
        raise ValueError(f"params fields {fields} != {Params._fields}")
    values = p.values() if isinstance(p, Mapping) else p
    out = []
    for default, v in zip(Params(), values):
        if isinstance(default, tuple):
            arr = np.asarray(v, np.float64)
            if arr.shape != np.shape(default):
                raise ValueError(f"params field of shape {arr.shape}, expected {np.shape(default)}")
            out.append(tuple(map(float, arr)) if arr.ndim == 1
                       else tuple(tuple(map(float, row)) for row in arr))
        else:
            out.append(float(np.asarray(v)))
    return Params(*out)


def substep_count(t: torch.Tensor, dt, ds) -> torch.Tensor:
    """``ceil(((t + dt) - t) / ds)`` in ``t``'s dtype: the live substep count
    of the step that starts at ``t``, as an int64 tensor.  ``dt`` and ``ds``
    are tensors of ``t``'s dtype, so every operation rounds there."""
    return torch.ceil(((t + dt) - t) / ds).to(torch.int64)


def trj_gen(p: Params, t: torch.Tensor) -> torch.Tensor:
    """Quintic min-jerk reference applied to x, y, z and yaw, ``(..., 11)``
    ``[pos(3), vel(3), acc(3), yaw, yaw rate]`` (reference
    ``reinmav_env.py:128-136``)."""
    t_max = p.t_max
    tc = torch.clamp(torch.clamp(t, max=t_max), min=0.0) / t_max
    pos = 10.0 * tc**3 - 15.0 * tc**4 + 6.0 * tc**5
    vel = (30.0 / t_max) * tc**2 - (60.0 / t_max) * tc**3 + (30.0 / t_max) * tc**4
    acc = (60.0 / t_max**2) * tc - (180.0 / t_max**2) * tc**2 + (120.0 / t_max**2) * tc**3
    return torch.stack([pos, pos, pos, vel, vel, vel, acc, acc, acc, pos, vel], dim=-1)


def state_to_qd(s13: torch.Tensor) -> torch.Tensor:
    """``[pos, vel, quat, pqr]`` -> ``[pos, vel, ZXY euler, pqr]``, ``(..., 12)``
    (reference ``stateToQd``, ``reinmav_env.py:292-304``)."""
    rot = qm.quat_to_rotmat_nonunit(s13[..., 6:10])
    phi, theta, psi = qm.rot_to_rpy_zxy(rot)
    return torch.cat([s13[..., 0:6], torch.stack([phi, theta, psi], dim=-1), s13[..., 10:13]],
                     dim=-1)


def inner_controller(p: Params, cur: torch.Tensor, des: torch.Tensor):
    """PD force/moment controller (reference ``controller``,
    ``reinmav_env.py:306-337``): ``(u1 (...,), moment (..., 3))``."""
    kp, kd = cur.new_tensor(p.kp), cur.new_tensor(p.kd)
    kp_rot, kd_rot = cur.new_tensor(p.kp_rot), cur.new_tensor(p.kd_rot)
    error_p = des[..., 0:3] - cur[..., 0:3]
    error_v = des[..., 3:6] - cur[..., 3:6]
    phi, theta, psi = cur[..., 6], cur[..., 7], cur[..., 8]
    pq = cur[..., 9:12]
    psi_des, dpsi_des = des[..., 9], des[..., 10]

    ddr = des[..., 6:9] + kd * error_v + kp * error_p
    u1 = p.mass * (p.gravity + ddr[..., 2])
    phi_des = (ddr[..., 0] * torch.sin(psi_des) - ddr[..., 1] * torch.cos(psi_des)) / p.gravity
    theta_des = (ddr[..., 0] * torch.cos(psi_des) + ddr[..., 1] * torch.sin(psi_des)) / p.gravity
    mx = kp_rot[0] * (phi_des - phi) - kd_rot[0] * pq[..., 0]
    my = kp_rot[1] * (theta_des - theta) - kd_rot[1] * pq[..., 1]
    mz = kp_rot[2] * (psi_des - psi) + kd_rot[2] * (dpsi_des - pq[..., 2])
    return u1, torch.stack([mx, my, mz], dim=-1)


def eom(p: Params, s13: torch.Tensor, force: torch.Tensor, moment: torch.Tensor) -> torch.Tensor:
    """Rigid-body equations of motion with motor mixing, ``(..., 13)``
    (reference ``quad_eq_of_motion2``, ``reinmav_env.py:201-264``)."""
    arm = p.arm_length
    a_mix = s13.new_tensor([[0.25, 0.0, -0.5 / arm],
                            [0.25, 0.5 / arm, 0.0],
                            [0.25, 0.0, 0.5 / arm],
                            [0.25, -0.5 / arm, 0.0]])
    cmd = torch.stack([force, moment[..., 0], moment[..., 1]], dim=-1)
    t_rotor = torch.clamp((a_mix @ cmd[..., None])[..., 0], p.min_force / 4.0, p.max_force / 4.0)
    total_force = t_rotor.sum(dim=-1)
    # Mz passes through unclamped (Q9).
    mixed_moment = torch.stack([arm * (t_rotor[..., 1] - t_rotor[..., 3]),
                                arm * (t_rotor[..., 2] - t_rotor[..., 0]), moment[..., 2]], dim=-1)

    vel, quat, pqr = s13[..., 3:6], s13[..., 6:10], s13[..., 10:13]
    brw = qm.quat_to_rotmat_nonunit(quat)
    accel = (brw[..., 2, :] * total_force[..., None]
             - s13.new_tensor([0.0, 0.0, p.mass * p.gravity])) / p.mass

    pq, q_, r_ = pqr.unbind(-1)
    w0, x0, y0, z0 = quat.unbind(-1)
    # qdot = -1/2 Omega(p, q, r) q + K_quat (1 - |q|^2) q, Omega as in the reference.
    qdot = torch.stack([-0.5 * (-pq * x0 - q_ * y0 - r_ * z0),
                        -0.5 * (pq * w0 - r_ * y0 + q_ * z0),
                        -0.5 * (q_ * w0 + r_ * x0 - pq * z0),
                        -0.5 * (r_ * w0 - q_ * x0 + pq * y0)], dim=-1)
    quat_err = 1.0 - (w0 * w0 + x0 * x0 + y0 * y0 + z0 * z0)
    qdot = qdot + p.k_quat * quat_err[..., None] * quat

    inertia = s13.new_tensor(p.inertia)
    inv_inertia = torch.linalg.inv(inertia)
    temp = torch.linalg.cross(pqr, (inertia @ pqr[..., None])[..., 0], dim=-1)
    pqrdot = (inv_inertia @ (mixed_moment - temp)[..., None])[..., 0]
    return torch.cat([vel, accel, qdot, pqrdot], dim=-1)


def step(p: Params, s: torch.Tensor, a: torch.Tensor | None = None) -> StepOut:
    """One outer step: the masked 51-iteration substep loop with the
    controller re-evaluated at every substep (reference
    ``myODE``/``quad_eq_of_motion1``, ``reinmav_env.py:90-98``)."""
    del a  # the reference step() takes no action (Q9)
    s13, t = s[..., :13], s[..., 13]
    dt, ds = s.new_tensor(p.dt), s.new_tensor(p.ds)
    n_sub = substep_count(t, dt, ds)
    for k in range(MAX_SUBSTEPS):
        tk = t + k * ds
        force, moment = inner_controller(p, state_to_qd(s13), trj_gen(p, tk))
        sdot = eom(p, s13, force, moment)
        s13 = torch.where((k < n_sub)[..., None], s13 + ds * sdot, s13)
    state = torch.cat([s13, (t + dt)[..., None]], dim=-1)
    reward = torch.full_like(t, 90.0)  # 100 alive bonus - 10 (Q9)
    return StepOut(state, s13, reward, torch.ones_like(t, dtype=torch.bool))


def reset(params, generator, batch, device, dtype):
    """The documented init state at t = 0 (reference ``init_state``,
    ``reinmav_env.py:79``); the generator is not read."""
    del params, generator
    row = torch.tensor(INIT_STATE + (0.0,), dtype=dtype, device=device)
    return row.expand(batch, STATE_DIM).clone()


def make(params: Params | None = None) -> EnvDef:
    return EnvDef(name="reinmav-v0", state_dim=STATE_DIM, action_dim=0, obs_dim=13,
                  params=params or Params(), step_fn=step, reset_fn=reset,
                  deterministic_reset=True)
