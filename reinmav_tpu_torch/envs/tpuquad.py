"""The rigid-body quadrotor family in PyTorch: ``MujocoQuadForce-v0``,
``MujocoQuadForce-v1`` (the hover task) and ``MujocoQuadQuat-v0``.

The counterpart of :mod:`reinmav_tpu.envs.tpuquad` (see there for the
derivation of every constant from the reference's MuJoCo XML): a free
rigid body with the geom-derived mass and diagonal inertia, a CoM offset
along body z, semi-implicit Euler substeps (``frame_skip`` per env step),
the exponential-map quaternion update, MuJoCo's inertia-box fluid drag,
and the ground plane as MuJoCo's soft-constraint contact: the coupled
dual QP over 48 candidate points x 4 pyramid rows, solved by 120 sweeps
of the hybrid projected Gauss-Seidel (Gauss-Seidel across the row types,
damped Jacobi across the candidates), in the JAX sweep order.

State and observation ``[pos(3), quat wxyz(4), vel(3), omega_body(3)]``,
13-dim.  ``step`` works on the trailing axis, for one env ``(13,)`` or a
batch ``(..., 13)``.

The contact solve is batched as the hot path wants it:

* the gate reads the candidates' world z only, ``(B, 48)``, never the
  ``(B, 48, 3)`` world points;
* only the envs that penetrate are solved (an index-select of that
  subset), on the 16 core and thruster candidates, or on all 48 for the
  envs where an arm corner penetrates.  With no arm corner below the
  plane the 16-candidate solve is the 48-candidate one: inactive
  candidates add exact zeros to every sweep stage and to the ``1 /
  n_active`` damping.  A batch with no penetration pays for the z gate
  only, and its contact force is exactly zero.

Rewards and termination as in the reference: Force-v0 and Quat-v0 reward
0 and end on a non-finite state; Force-v1 (hovering) rewards ``-10
|pos - (0,0,1)|^2 - 0.1 |qvel|^2 - |a|^2 + 0.1 sum(a) + 100`` with the RAW
action (the dynamics use the clipped one) and ends on a non-finite
state, ``z <= 0.3`` or ``|x|, |y| >= 2``.  Resets are deterministic, to
``(0, 0, init_z)`` at rest (``EnvDef.deterministic_reset``).
"""

from __future__ import annotations

import math
from collections.abc import Mapping
from typing import NamedTuple

import numpy as np
import torch

from ..ops import quadmath as qm
from .core import EnvDef, StepOut

# MuJoCo's default soft-constraint constants (solref (0.02, 1), solimp
# (0.9, 0.95, 0.001, 0.5, 2)): K = 1 / (dmax^2 tau^2 zeta^2), B = 2 / (dmax tau).
_CONTACT_K = 2770.083102493075
_CONTACT_B = 105.26315789473685
_IMP_D0, _IMP_DMAX, _IMP_WIDTH = 0.9, 0.95, 0.001


class Params(NamedTuple):
    """The force models' constants (``reinmav_tpu.envs.tpuquad.Params``)."""

    mass: float = 0.3
    inertia_diag: tuple = (0.0016787227432770446, 0.0017578105900562893, 0.0033807)
    com_z: float = 0.003333333333333333
    gravity: float = -9.81
    dt: float = 0.01
    frame_skip: int = 2
    init_z: float = 0.0
    arm_xy: float = 0.1
    yaw_gear: float = 0.1
    ctrl_high: float = 1.0
    contact_friction: float = 1.0
    contact_enabled: bool = True
    density: float = 1.0
    viscosity: float = 1e-5
    box_dims: tuple = (0.2630508637803436, 0.25696739688998504, 0.03341656275960588)


class QuatParams(NamedTuple):
    """The quat model's constants (``reinmav_tpu.envs.tpuquad.QuatParams``)."""

    mass: float = 0.4
    inertia_diag: tuple = (0.0017412227432770442, 0.0018994772567229557, 0.0035415333333333335)
    com_z: float = 0.0025
    gravity: float = -9.81
    dt: float = 0.01
    frame_skip: int = 2
    init_z: float = 0.0
    thrust_high: float = 4.0
    rate_kv: float = 0.1
    rate_ctrl_high: float = 1.0
    contact_friction: float = 1.0
    contact_enabled: bool = True
    density: float = 1.0
    viscosity: float = 1e-5
    box_dims: tuple = (0.2355776256389572, 0.2252757916384078, 0.038568121551353786)


def params_from_jax(p, params_type=None):
    """The JAX package's ``tpuquad.Params`` or ``QuatParams`` (or a mapping
    of its fields, values as Python or NumPy scalars and tuples) as the
    port's.  ``params_type`` picks the port's type for a mapping (default:
    by the field names).  Raises ``ValueError`` if the fields or their
    order differ."""
    fields = tuple(p.keys()) if isinstance(p, Mapping) else getattr(type(p), "_fields", None)
    if params_type is None:
        params_type = QuatParams if fields == QuatParams._fields else Params
    if fields != params_type._fields:
        raise ValueError(f"params fields {fields} != {params_type._fields}")
    values = p.values() if isinstance(p, Mapping) else p
    out = []
    for default, v in zip(params_type(), values):
        if isinstance(default, tuple):
            out.append(tuple(float(x) for x in np.asarray(v, np.float64).reshape(-1)))
        elif isinstance(default, bool):
            out.append(bool(np.asarray(v)))
        elif isinstance(default, int):
            out.append(int(np.asarray(v)))
        else:
            out.append(float(np.asarray(v)))
    return params_type(*out)


# Motor body-frame positions and yaw-torque signs (XML site and gear order).
_MOTOR_X = (1.0, 1.0, -1.0, -1.0)
_MOTOR_Y = (1.0, -1.0, -1.0, 1.0)
_YAW_SIGN = (-1.0, 1.0, -1.0, 1.0)

# Contact candidates, in the JAX package's order: the core box's 8 corners,
# the 4 thruster cylinders' upper then lower cap centres (the deepest rim
# point is the centre plus r along the steepest-descent direction), and the
# 4 arm boxes' 8 corners each.
_CORE_CORNERS = tuple((sx * 0.06, sy * 0.035, sz * 0.025)
                      for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1))
_THRUSTER_CENTERS = ((0.1, 0.1, 0.01), (0.1, -0.1, 0.01), (-0.1, -0.1, 0.01), (-0.1, 0.1, 0.01))
_THRUSTER_R, _THRUSTER_HH = 0.05, 0.0025
_CAPS = (tuple((x, y, z + _THRUSTER_HH) for x, y, z in _THRUSTER_CENTERS)
         + tuple((x, y, z - _THRUSTER_HH) for x, y, z in _THRUSTER_CENTERS))
# The arm boxes of quadrotor_ground.xml:9-12: (centre, z-quaternion (w, z),
# half sizes), as reinmav_tpu/oracle/tpuquad_ref.py transcribes them.
_ARM_GEOMS = (
    ((0.071, 0.071, 0.0), (0.924, 0.383), (0.05, 0.01, 0.0025)),
    ((0.071, -0.071, 0.0), (0.383, 0.924), (0.05, 0.01, 0.0025)),
    ((-0.071, -0.071, 0.0), (-0.383, 0.924), (0.05, 0.01, 0.0025)),
    ((-0.071, 0.071, 0.0), (0.924, -0.383), (0.05, 0.01, 0.0025)),
)


def _arm_corners():
    """(32, 3) body-frame corners of the four arm boxes, from the XML
    centre, z-rotation and half sizes (the angle is ``2 atan2(qz, qw)``,
    whatever the quaternion's norm)."""
    out = []
    for center, (qw, qz), (hx, hy, hz) in _ARM_GEOMS:
        th = 2.0 * np.arctan2(qz, qw)
        cth, sth = np.cos(th), np.sin(th)
        rot = np.array([[cth, -sth, 0.0], [sth, cth, 0.0], [0.0, 0.0, 1.0]])
        corners = np.array([[sx * hx, sy * hy, sz * hz]
                            for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)])
        out.append(np.asarray(center, float) + corners @ rot.T)
    return tuple(tuple(float(v) for v in row) for row in np.concatenate(out))


_ARM_CORNERS = _arm_corners()
#: Candidates with a fixed body point (core and arm corners) and the caps.
N_CORE, N_CAPS, N_ARM = len(_CORE_CORNERS), len(_CAPS), len(_ARM_CORNERS)
N_SMALL = N_CORE + N_CAPS  # 16: the tier solved when no arm corner penetrates
N_CANDIDATES = N_SMALL + N_ARM  # 48
# Pyramid tangents of the z-plane floor (mju_makeFrame(0, 0, 1) order).
_PYRAMID_T = ((0.0, 1.0, 0.0), (-1.0, 0.0, 0.0))
_PGS_ITERS = 120


def _cross(a, b):
    return torch.linalg.cross(*torch.broadcast_tensors(a, b), dim=-1)


def _mv(m, v):
    """Batched matrix-vector product ``m @ v``: ``(N, 3, 3)``, ``(N, 3)``."""
    return (m @ v[..., None])[..., 0]


def _quat_integrate(quat, omega_body, dt):
    """``q ⊗ exp(½ ω dt)``, renormalised; sinc-safe, so ω → 0 is exact."""
    rot_vec = omega_body * dt
    angle = torch.linalg.vector_norm(rot_vec, dim=-1)
    half = 0.5 * angle
    big = angle > 1e-9
    safe_angle = torch.where(big, angle, torch.ones_like(angle))
    sinc_half = torch.where(big, torch.sin(half) / safe_angle, torch.full_like(angle, 0.5))
    dq = torch.cat([torch.cos(half)[..., None], rot_vec * sinc_half[..., None]], dim=-1)
    return qm.quat_normalize(qm.quat_mul(quat, dq))


def _impedance(pen):
    """MuJoCo's solimp spline d(pen): power 2, midpoint 0.5, from d0 to
    dmax over ``width`` of penetration."""
    x = torch.clamp(pen / _IMP_WIDTH, 0.0, 1.0)
    s = torch.where(x <= 0.5, 2.0 * x * x, 1.0 - 2.0 * torch.square(1.0 - x))
    return _IMP_D0 + s * (_IMP_DMAX - _IMP_D0)


def _fluid_wrench_body(p, vel_com_b, omega_b):
    """MuJoCo's inertia-box fluid drag in the body frame: per-axis
    quadratic density terms and the Stokes equivalent-sphere viscous
    terms.  Returns ``(force, torque)``."""
    D = p.box_dims
    diam = (D[0] + D[1] + D[2]) / 3.0
    f = -3.0 * math.pi * p.viscosity * diam * vel_com_b
    t = -math.pi * p.viscosity * diam**3 * omega_b
    fq, tq = [], []
    for i in range(3):
        j, k = (i + 1) % 3, (i + 2) % 3
        v, w = vel_com_b[..., i], omega_b[..., i]
        fq.append(-0.5 * p.density * D[j] * D[k] * torch.abs(v) * v)
        tq.append(-p.density * D[i] * (D[j] ** 4 + D[k] ** 4) / 64.0 * torch.abs(w) * w)
    return f + torch.stack(fq, dim=-1), t + torch.stack(tq, dim=-1)


def _cap_direction(rot):
    """The thruster caps' steepest-descent rim direction in the world
    frame, ``(N, 3)``: ``(0, 0, -1) + a_z a`` for the body z axis ``a``,
    normalised, and zero for an exactly level body."""
    axis = rot[..., :, 2]
    u = axis * axis[..., 2:3] + axis.new_tensor([0.0, 0.0, -1.0])
    nu = torch.linalg.vector_norm(u, dim=-1, keepdim=True)
    ok = nu > 1e-12
    return torch.where(ok, u / torch.where(ok, nu, torch.ones_like(nu)), torch.zeros_like(u))


def _body_points(dtype, device, n_cand: int):
    """The first ``n_cand`` candidates' body points, ``(n_cand, 3)``."""
    pts = (_CORE_CORNERS + _CAPS + _ARM_CORNERS)[:n_cand]
    return torch.tensor(pts, dtype=dtype, device=device)


def candidate_z(pos, rot):
    """World z of the 48 contact candidates, ``(N, 48)``, from the body z
    row of the rotation alone (the gate of the contact solve)."""
    pts = _body_points(pos.dtype, pos.device, N_CANDIDATES)
    z = pos[:, 2:3] + rot[:, 2, :] @ pts.T
    cap_dz = _THRUSTER_R * _cap_direction(rot)[:, 2:3]
    return torch.cat([z[:, :N_CORE], z[:, N_CORE:N_SMALL] + cap_dz, z[:, N_SMALL:]], dim=1)


def _contact_points(pos, rot, n_cand: int):
    """World points of the first ``n_cand`` candidates, ``(S, n_cand, 3)``."""
    pts = pos[:, None, :] + _body_points(pos.dtype, pos.device, n_cand) @ rot.transpose(-1, -2)
    cap = (_THRUSTER_R * _cap_direction(rot))[:, None, :]
    return torch.cat([pts[:, :N_CORE], pts[:, N_CORE:N_SMALL] + cap, pts[:, N_SMALL:]], dim=1)


def _contact_solve(p, pos, vel, omega_body, rot, acc0_com, alpha0, n_cand: int):
    """The coupled contact solve over the first ``n_cand`` candidates (16 or
    48) of ``S`` envs: ``f* = argmin_{f >= 0} ½ fᵀ(A + R)f + fᵀ(J a_smooth -
    aref)`` over the candidates x 4 pyramid rows ``e = n ± mu t``, the
    inactive ones masked, by the matrix-free hybrid sweep.  Returns the
    world force and the body torque about the CoM, ``(S, 3)`` each."""
    dtype, dev = pos.dtype, pos.device
    inertia = pos.new_tensor(p.inertia_diag)
    c = pos.new_tensor([0.0, 0.0, p.com_z])
    inv_m = 1.0 / p.mass
    mu = p.contact_friction

    pts = _contact_points(pos, rot, n_cand)                      # (S, nc, 3)
    dist = pts[..., 2]
    active = dist < 0.0
    pen = -dist
    mid = torch.cat([pts[..., :2], (0.5 * dist)[..., None]], dim=-1)  # midpoint shift
    com_w = pos + _mv(rot, c.expand_as(pos))
    rho_b = (mid - com_w[:, None, :]) @ rot                       # Rᵀx, row-wise
    r_b = (mid - pos[:, None, :]) @ rot                           # from the origin
    d = _impedance(pen)
    R_reg = (1.0 - d) / d * (2.0 * mu * mu * (1.0 + mu * mu) * inv_m)

    # Point velocities and smooth accelerations in ORIGIN coordinates (no
    # centripetal term in a0 = J qacc_smooth, as the engine).
    rot_t = rot.transpose(-1, -2)
    v_pt = vel[:, None, :] + _cross(omega_body[:, None, :], r_b) @ rot_t
    a_o0 = acc0_com - _mv(rot, _cross(alpha0, c) + _cross(omega_body, _cross(omega_body, c)))
    a_pt0 = a_o0[:, None, :] + _cross(alpha0[:, None, :], r_b) @ rot_t

    n = torch.tensor([0.0, 0.0, 1.0], dtype=dtype, device=dev)
    t = torch.tensor(_PYRAMID_T, dtype=dtype, device=dev)
    edges = torch.stack([n + mu * t[0], n - mu * t[0], n + mu * t[1], n - mu * t[1]])  # (4, 3)
    edges_b = edges @ rot                                         # Rᵀe, (S, 4, 3)

    arm = _cross(rho_b[:, :, None, :], edges_b[:, None, :, :])   # (S, nc, 4, 3)
    diag = ((edges * edges).sum(dim=1) * inv_m) + (arm * arm / inertia).sum(dim=-1) \
        + R_reg[..., None]
    vel_rows = v_pt @ edges.T                                     # (S, nc, 4)
    aref = (d * _CONTACT_K * pen)[..., None] - _CONTACT_B * vel_rows
    b_rows = a_pt0 @ edges.T - aref

    # Each stage is a handful of batched tensor ops over the candidates:
    # w / diag is formed once, the inactive rows are masked by a 0/1 factor,
    # and the aggregate wrench's sums over the candidates are products.
    act = active.to(dtype)
    w = 1.0 / torch.clamp(act.sum(dim=1), min=1.0)
    arms = [arm[:, :, k, :].contiguous() for k in range(4)]
    b_k = [b_rows[..., k].contiguous() for k in range(4)]
    w_diag = [w[:, None] / diag[..., k] for k in range(4)]
    e_m = [(edges[k] * inv_m)[:, None] for k in range(4)]
    f = [torch.zeros_like(dist)] * 4
    F_w = torch.zeros_like(pos)
    T_b = torch.zeros_like(pos)
    for _ in range(_PGS_ITERS):
        for k in range(4):
            Af = torch.bmm(arms[k], (T_b / inertia)[:, :, None])[..., 0] + F_w @ e_m[k]
            new = torch.clamp(f[k] - (torch.addcmul(Af, R_reg, f[k]) + b_k[k]) * w_diag[k],
                              min=0.0)
            df = (new - f[k]) * act
            f[k] = f[k] + df
            F_w = F_w + edges[k] * df.sum(dim=1, keepdim=True)
            T_b = T_b + torch.bmm(df[:, None, :], arms[k])[:, 0]
    return F_w, T_b


def _contact_wrench(p, pos, vel, omega_body, rot, acc0_com, alpha0):
    """The gated contact wrench of ``N`` envs, ``(N, 3)`` world force and
    body torque: zero where no candidate is below the plane; the envs that
    penetrate are solved as a subset, on 48 candidates where an arm corner
    penetrates, else on 16."""
    z = candidate_z(pos, rot)
    below = z < 0.0
    force, torque = torch.zeros_like(pos), torch.zeros_like(pos)
    hit = torch.nonzero(below.any(dim=1)).squeeze(1)
    if hit.numel() == 0:
        return force, torque
    arm_hit = below[hit, N_SMALL:].any(dim=1)
    args = (pos, vel, omega_body, rot, acc0_com, alpha0)
    for idx, n_cand in ((hit[~arm_hit], N_SMALL), (hit[arm_hit], N_CANDIDATES)):
        if idx.numel():
            f_w, t_b = _contact_solve(p, *(a[idx] for a in args), n_cand=n_cand)
            force[idx], torque[idx] = f_w, t_b
    return force, torque


def _physics_step(p, state, thrust_per_motor, yaw_torque, extra_torque_b):
    """One semi-implicit Euler substep of ``(N, 13)`` free bodies.

    ``thrust_per_motor`` ``(N, 4)`` forces along body z at the motor
    positions, ``yaw_torque`` ``(N,)`` body-z torque of the motor gears,
    ``extra_torque_b`` ``(N, 3)`` (the rate servos).  Dynamics about the
    CoM, mapped to the body-origin free joint with the full coupling ``a_o
    = a_c - R(α × c + ω × (ω × c))``; velocities first, then positions from
    the new velocities, then the exp-map quaternion update."""
    pos, quat, vel, omega = state[:, 0:3], state[:, 3:7], state[:, 7:10], state[:, 10:13]
    dt = p.dt
    rot = qm.quat_to_rotmat(qm.quat_normalize(quat))
    inertia = state.new_tensor(p.inertia_diag)
    c = state.new_tensor([0.0, 0.0, p.com_z])

    total_thrust = thrust_per_motor.sum(dim=-1)
    force_w = rot[:, :, 2] * total_thrust[:, None] + state.new_tensor([0.0, 0.0, p.gravity * p.mass])
    # τ = Σ rᵢ × (Fᵢ ẑ) = Σ Fᵢ (yᵢ, -xᵢ, 0) in the body frame.
    mx = thrust_per_motor @ state.new_tensor([y * p.arm_xy for y in _MOTOR_Y])
    my = -(thrust_per_motor @ state.new_tensor([x * p.arm_xy for x in _MOTOR_X]))
    torque_b = torch.stack([mx, my, yaw_torque], dim=-1) + extra_torque_b

    # Fluid drag acts at the CoM.
    vel_com_b = _mv(rot.transpose(-1, -2), vel) + _cross(omega, c)
    df, dtq = _fluid_wrench_body(p, vel_com_b, omega)
    force_w = force_w + _mv(rot, df)
    torque_b = torque_b + dtq

    if p.contact_enabled:
        # Two passes: the unconstrained accelerations feed the contact law.
        alpha0 = (torque_b - _cross(omega, inertia * omega)) / inertia
        acc0_com = force_w / p.mass
        cf_w, ct_b = _contact_wrench(p, pos, vel, omega, rot, acc0_com, alpha0)
        force_w = force_w + cf_w
        torque_b = torque_b + ct_b

    omega_dot = (torque_b - _cross(omega, inertia * omega)) / inertia
    acc = force_w / p.mass - _mv(rot, _cross(omega_dot, c) + _cross(omega, _cross(omega, c)))
    vel_new = vel + acc * dt
    omega_new = omega + omega_dot * dt
    pos_new = pos + vel_new * dt
    quat_new = _quat_integrate(quat, omega_new, dt)
    return torch.cat([pos_new, quat_new, vel_new, omega_new], dim=-1)


def _flat(s, a):
    """``(..., 13)`` states and ``(..., 4)`` actions as ``(N, ·)`` rows."""
    lead = torch.broadcast_shapes(s.shape[:-1], a.shape[:-1])
    return (s.expand(*lead, 13).reshape(-1, 13), a.expand(*lead, a.shape[-1]).reshape(-1, a.shape[-1]),
            lead)


def _force_env_step(p: Params, s, a, hovering: bool) -> StepOut:
    state, raw_a, lead = _flat(s, a)
    ctrl = torch.clamp(raw_a, 0.0, p.ctrl_high)  # clip_action + ctrlrange clamp
    yaw = p.yaw_gear * (ctrl @ state.new_tensor(_YAW_SIGN))
    zero = torch.zeros_like(state[:, :3])
    for _ in range(p.frame_skip):
        state = _physics_step(p, state, ctrl, yaw, zero)
    finite = torch.isfinite(state).all(dim=-1)
    if hovering:
        pos_err = state[:, 0:3] - state.new_tensor([0.0, 0.0, 1.0])
        reward = (-10.0 * torch.square(pos_err).sum(dim=-1)
                  - 0.1 * torch.square(state[:, 7:13]).sum(dim=-1)
                  - torch.square(raw_a).sum(dim=-1)
                  + 0.1 * raw_a.sum(dim=-1)
                  + 100.0)
        alive = (finite & (state[:, 2] > 0.3) & (torch.abs(state[:, 0]) < 2.0)
                 & (torch.abs(state[:, 1]) < 2.0))
        done = ~alive
    else:
        reward = torch.zeros_like(state[:, 0])
        done = ~finite
    state = state.reshape(*lead, 13)
    return StepOut(state, state, reward.reshape(lead), done.reshape(lead))


def _quat_env_step(p: QuatParams, s, a) -> StepOut:
    state, a, lead = _flat(s, a)
    thrust_cmd = torch.clamp(a[:, 0], 0.0, p.thrust_high)
    rate_cmd = torch.clamp(a[:, 1:4], -p.rate_ctrl_high, p.rate_ctrl_high)
    # One central thrust (the site at the body origin): no roll or pitch moment.
    fp = Params(mass=p.mass, inertia_diag=p.inertia_diag, com_z=p.com_z, gravity=p.gravity,
                dt=p.dt, frame_skip=1, arm_xy=0.0, yaw_gear=0.0,
                contact_friction=p.contact_friction, contact_enabled=p.contact_enabled,
                density=p.density, viscosity=p.viscosity, box_dims=p.box_dims)
    thrusts = torch.cat([thrust_cmd[:, None], torch.zeros_like(state[:, :3])], dim=-1)
    yaw = torch.zeros_like(state[:, 0])
    for _ in range(p.frame_skip):
        servo_torque = p.rate_kv * (rate_cmd - state[:, 10:13])
        state = _physics_step(fp, state, thrusts, yaw, servo_torque)
    done = ~torch.isfinite(state).all(dim=-1)
    state = state.reshape(*lead, 13)
    return StepOut(state, state, torch.zeros_like(done, dtype=state.dtype).reshape(lead),
                   done.reshape(lead))


def _deterministic_reset(init_z: float):
    """Reset to the XML keyframe ``(0, 0, init_z)`` at rest, identity
    attitude; the generator is not read."""

    def reset_fn(params, generator, batch, device, dtype):
        del params, generator
        row = torch.tensor([0.0, 0.0, init_z, 1.0] + [0.0] * 9, dtype=dtype, device=device)
        return row.expand(batch, 13).clone()

    # Identity tag for the fused-kernel dispatch (core.fused_kernel_mismatch):
    # any product of this factory whose init_z is the env's Params.init_z is
    # the registry's reset, since the kernels read init_z from the params.
    reset_fn.det_reset_init_z = float(init_z)
    return reset_fn


# Module-level step and reset functions, so that a wrapped or customised
# env is detectable by identity (core.fused_kernel_mismatch).
def force_step(params, s, a):
    return _force_env_step(params, s, a, hovering=False)


def hovering_step(params, s, a):
    return _force_env_step(params, s, a, hovering=True)


quat_step = _quat_env_step
force_reset = _deterministic_reset(0.0)
hovering_reset = _deterministic_reset(1.0)
quat_reset = _deterministic_reset(0.0)


def make_force_ground(params: Params | None = None) -> EnvDef:
    p = params or Params(init_z=0.0)
    return EnvDef(name="MujocoQuadForce-v0", state_dim=13, action_dim=4, obs_dim=13, params=p,
                  step_fn=force_step,
                  reset_fn=force_reset if p.init_z == 0.0 else _deterministic_reset(p.init_z),
                  action_low=0.0, action_high=1.0, deterministic_reset=True)


def make_hovering(params: Params | None = None) -> EnvDef:
    p = params or Params(init_z=1.0)
    return EnvDef(name="MujocoQuadForce-v1", state_dim=13, action_dim=4, obs_dim=13, params=p,
                  step_fn=hovering_step,
                  reset_fn=hovering_reset if p.init_z == 1.0 else _deterministic_reset(p.init_z),
                  action_low=0.0, action_high=1.0, deterministic_reset=True)


def make_quat(params: QuatParams | None = None) -> EnvDef:
    p = params or QuatParams()
    return EnvDef(name="MujocoQuadQuat-v0", state_dim=13, action_dim=4, obs_dim=13, params=p,
                  step_fn=quat_step,
                  reset_fn=quat_reset if p.init_z == 0.0 else _deterministic_reset(p.init_z),
                  action_low=-1.0, action_high=4.0, deterministic_reset=True)
