"""Kernel K11: the contact envs' constant-action rollout (MujocoQuadForce-v0,
MujocoQuadQuat-v0), and its plain twin.

The counterpart of :func:`reinmav_tpu.ops.pallas_tpuquad.contact_rollout_pallas8`.
:func:`contact_rollout` runs ``horizon`` steps of ``frame_skip`` rigid-body
substeps under a constant action in one launch of a CUDA kernel written by
hand for Hopper (``csrc/contact_rollout.cu``) on a ``(13, B)`` float32
state.  Each substep solves MuJoCo's coupled plane contact: 48 candidate
points (8 core-box corners, 8 thruster-cap rim points, 32 arm-box
corners) x 4 pyramid rows, regularised by the impedance spline, by
``_PGS_ITERS`` sweeps of the hybrid projected Gauss-Seidel (Gauss-Seidel
across the four row types, mass-split Jacobi across the candidates).  The
quat model's rate servos act in every substep.  A non-finite state resets
to ``(0, 0, init_z)`` at rest.  The envs' reward is identically 0, so the
kernel returns the per-env sum of z over the steps (Σz) for the checks.

:func:`contact_rollout_reference` is its plain PyTorch twin, vectorised
over ``(B, 48)`` candidate tensors, in the TPU kernel's operation order
(``pallas_tpuquad._rigid_substep`` and ``_coupled_contact``), which is not
the algebra of the env's own solve (:func:`reinmav_tpu_torch.envs.tpuquad._contact_solve`).
Its sums over the candidates follow ``_candidate_sum``'s halving tree: 48
= 32 + 16, each halved pairwise.  An env with no candidate below the plane
skips the solve (its contact wrench is exactly zero); an env with no arm
corner below it sweeps the first 16 candidates only, which is bitwise the
48-candidate sweep, since inactive candidates add exact zeros (``force48``
sweeps all 48, for the check).  The twin runs in float32 (the kernel's
arithmetic) or float64 (held to the env's solve).  Divisions by a constant
divide by a tensor, never by a Python number, which the card's PyTorch
would turn into a product with the reciprocal.

The params travel as one vector (:func:`contact_params_vec`): the rigid
body, the drag, the contact and the constant action's wrench, each derived
in float64 on the host as the TPU kernel folds its Python constants, then
the 48 candidates' body points.  The sweep count is the module constant
:data:`_PGS_ITERS`, read at each call (the CPU tests lower it on both
sides, as the JAX package's tests do).

The wrapper takes the twin only for a tensor that lies on the CPU; on a
CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import math

import torch

D = 13
N_CANDIDATES, N_SMALL = 48, 16
_PGS_ITERS = 120
#: The scalars of the kernel's params vector, in the order
#: ``csrc/contact_rollout.cu`` reads them; the 48 x 3 candidate points follow.
SCALAR_FIELDS = (
    "mass", "ix", "iy", "iz", "cz", "inv_m", "inv_ix", "inv_iy", "inv_iz", "gm", "dt", "init_z",
    "mu", "kappa", "ee_inv_m", "cap_r",
    "kv", "kt", "fdx", "fdy", "fdz", "tdx", "tdy", "tdz",
    "total", "mx", "my", "mz", "servo", "servo_kv", "cmd0", "cmd1", "cmd2")
N_PARAMS = len(SCALAR_FIELDS) + 3 * N_CANDIDATES
# MuJoCo's soft-contact constants (envs/tpuquad.py).
_CONTACT_K = 2770.083102493075
_CONTACT_B = 105.26315789473685
_IMP_D0, _IMP_DMAX, _IMP_WIDTH = 0.9, 0.95, 0.001
#: The pyramid rows in sweep order: (tangent index, sign).
_STAGES = ((1, 1.0), (1, -1.0), (2, 1.0), (2, -1.0))


def contact_params_vec(p=None, action=(0.0, 0.0, 0.0, 0.0),
                       dtype=torch.float32) -> torch.Tensor:
    """The env's Params (``envs.tpuquad.Params`` for the force model,
    ``QuatParams`` for the quat model; the force model's defaults when None)
    and the constant raw ``action`` -> the kernel's params vector on the
    CPU, :data:`SCALAR_FIELDS` then the candidates' body points.  Every
    derived constant is computed in float64 as the TPU kernel folds its
    Python constants, then cast to ``dtype`` (float32 for the kernel;
    float64 holds the twin to the env).  Params of another type raise, and
    so does ``contact_enabled=False``, which the kernel cannot honour."""
    from ..envs import tpuquad

    p = tpuquad.Params() if p is None else p
    if type(p) not in (tpuquad.Params, tpuquad.QuatParams):
        raise ValueError(f"contact params must be envs.tpuquad.Params or QuatParams, got "
                         f"{type(p).__name__}")
    if not p.contact_enabled:
        raise ValueError("the contact kernel always solves the contact: contact_enabled=False")
    if len(action) != 4:
        raise ValueError(f"action must be 4 raw controls, got {action}")
    a = [float(x) for x in action]
    m = float(p.mass)
    ix, iy, iz = (float(v) for v in p.inertia_diag)
    mu = float(p.contact_friction)
    dx, dy, dz = (float(v) for v in p.box_dims)
    diam = (dx + dy + dz) / 3.0
    rho = float(p.density)
    if type(p) is tpuquad.Params:
        ctrl = [min(max(x, 0.0), float(p.ctrl_high)) for x in a]
        wrench = (float(sum(ctrl)),
                  p.arm_xy * float(sum(y * u for y, u in zip(tpuquad._MOTOR_Y, ctrl))),
                  -p.arm_xy * float(sum(x * u for x, u in zip(tpuquad._MOTOR_X, ctrl))),
                  p.yaw_gear * float(sum(s * u for s, u in zip(tpuquad._YAW_SIGN, ctrl))))
        servo = (0.0, 0.0, 0.0, 0.0, 0.0)
    else:
        wrench = (float(min(max(a[0], 0.0), float(p.thrust_high))), 0.0, 0.0, 0.0)
        hi = float(p.rate_ctrl_high)
        servo = (1.0, float(p.rate_kv), *(min(max(x, -hi), hi) for x in a[1:4]))
    scalars = dict(
        mass=m, ix=ix, iy=iy, iz=iz, cz=p.com_z, inv_m=1.0 / m, inv_ix=1.0 / ix,
        inv_iy=1.0 / iy, inv_iz=1.0 / iz, gm=p.gravity * m, dt=p.dt, init_z=p.init_z, mu=mu,
        kappa=2.0 * mu * mu * (1.0 + mu * mu) * (1.0 / m), ee_inv_m=(1.0 + mu * mu) * (1.0 / m),
        cap_r=tpuquad._THRUSTER_R,
        kv=3.0 * math.pi * p.viscosity * diam, kt=math.pi * p.viscosity * diam**3,
        fdx=0.5 * rho * dy * dz, fdy=0.5 * rho * dz * dx, fdz=0.5 * rho * dx * dy,
        tdx=rho * dx * (dy**4 + dz**4) / 64.0, tdy=rho * dy * (dz**4 + dx**4) / 64.0,
        tdz=rho * dz * (dx**4 + dy**4) / 64.0,
        total=wrench[0], mx=wrench[1], my=wrench[2], mz=wrench[3],
        servo=servo[0], servo_kv=servo[1], cmd0=servo[2], cmd1=servo[3], cmd2=servo[4])
    points = tpuquad._CORE_CORNERS + tpuquad._CAPS + tpuquad._ARM_CORNERS
    values = [float(scalars[k]) for k in SCALAR_FIELDS] + [float(v) for pt in points for v in pt]
    return torch.tensor(values, dtype=dtype)


def _halving_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis, a power of two wide, by pairwise halving:
    ``x[..., :h] + x[..., h:]`` until one column is left."""
    while x.shape[-1] > 1:
        h = x.shape[-1] // 2
        x = x[..., :h] + x[..., h:]
    return x[..., 0]


def candidate_sum(x: torch.Tensor) -> torch.Tensor:
    """``_candidate_sum``'s order over the last axis (16 or 48 candidates):
    48 = the halving sum of the first 32 plus that of the last 16."""
    if x.shape[-1] == N_CANDIDATES:
        return _halving_sum(x[..., :32]) + _halving_sum(x[..., 32:])
    return _halving_sum(x)


def _sweep(c: dict, act, Ri, arms, bs, rds):
    """``_PGS_ITERS`` sweeps of the hybrid PGS over ``(S, nc)`` candidates:
    the aggregate wrench ``(Fx, Fy, Fz, Wx, Wy, Wz)``, W in body
    accelerations (torque over inertia)."""
    mu, inv_m = c["mu"], c["inv_m"]
    inv_i = (c["inv_ix"], c["inv_iy"], c["inv_iz"])
    n_act = candidate_sum(act.to(Ri.dtype))
    w = (1.0 / torch.clamp(n_act, min=1.0))[:, None]  # mass-split Jacobi damping
    f = [torch.zeros_like(Ri) for _ in range(4)]
    zero = Ri.new_zeros(Ri.shape[0])
    Fx, Fy, Fz, Wx, Wy, Wz = (zero,) * 6
    for _ in range(_PGS_ITERS):
        for k, (tj, s) in enumerate(_STAGES):
            smu = s * mu
            eF = Fz + smu * (Fy if tj == 1 else -Fx)
            arm = arms[k]
            Af = ((eF * inv_m)[:, None] + arm[0] * Wx[:, None] + arm[1] * Wy[:, None]
                  + arm[2] * Wz[:, None])
            new = f[k] - w * (Af + Ri * f[k] + bs[k]) * rds[k]
            new = torch.where(new < 0.0, 0.0, new)
            df = torch.where(act, new - f[k], 0.0)
            f[k] = f[k] + df
            sums = candidate_sum(torch.stack([df, arm[0] * df, arm[1] * df, arm[2] * df], dim=1))
            sdf = sums[:, 0]
            Fz = Fz + sdf
            if tj == 1:
                Fy = Fy + smu * sdf
            else:
                Fx = Fx - smu * sdf
            Wx = Wx + sums[:, 1] * inv_i[0]
            Wy = Wy + sums[:, 2] * inv_i[1]
            Wz = Wz + sums[:, 3] * inv_i[2]
    return Fx, Fy, Fz, Wx, Wy, Wz


def _impedance(pen):
    """MuJoCo's solimp spline d(pen), as the TPU kernel writes it."""
    x = torch.clamp(pen * (1.0 / _IMP_WIDTH), 0.0, 1.0)
    s = torch.where(x <= 0.5, 2.0 * x * x, 1.0 - 2.0 * (1.0 - x) * (1.0 - x))
    return _IMP_D0 + s * (_IMP_DMAX - _IMP_D0)


def coupled_contact(c: dict, points: torch.Tensor, pos, rot, vel, omega, force, torque, gyro,
                    force48: bool = False):
    """The coupled plane-contact solve (``_coupled_contact``) of ``B`` envs
    on component rows: takes the unconstrained force and torque and returns
    them with the contact wrench added, and the tier each env ran, ``(B,)``
    int64: 0 no contact, 1 the first 16 candidates, 2 all 48.  ``points``:
    the ``(48, 3)`` candidates' body points."""
    px, py, pz = pos
    r00, r01, r02, r10, r11, r12, r20, r21, r22 = rot
    vx, vy, vz = vel
    ox, oy, oz = omega
    fx, fy, fz = force
    tx, ty, tz = torque
    gyx, gyy, gyz = gyro
    cz, mu = c["cz"], c["mu"]

    def col(x):
        return x[:, None]

    # Unconstrained accelerations; a_o0 in ORIGIN coordinates.
    a0x, a0y, a0z = fx * c["inv_m"], fy * c["inv_m"], fz * c["inv_m"]
    al0x = (tx - gyx) * c["inv_ix"]
    al0y = (ty - gyy) * c["inv_iy"]
    al0z = (tz - gyz) * c["inv_iz"]
    u0 = (al0y + oz * ox) * cz
    u1 = (-al0x + oz * oy) * cz
    u2 = -(ox * ox + oy * oy) * cz
    aox = a0x - (r00 * u0 + r01 * u1 + r02 * u2)
    aoy = a0y - (r10 * u0 + r11 * u1 + r12 * u2)
    aoz = a0z - (r20 * u0 + r21 * u1 + r22 * u2)

    # The thruster caps' rim direction u (radial steepest descent, guarded).
    uwx, uwy, uwz = r22 * r02, r22 * r12, r22 * r22 - 1.0
    nu2 = uwx * uwx + uwy * uwy + uwz * uwz
    inv_nu = torch.where(nu2 > 1e-24, torch.rsqrt(torch.clamp(nu2, min=1e-30)), 0.0)
    uwx, uwy, uwz = uwx * inv_nu, uwy * inv_nu, uwz * inv_nu

    # Per candidate, (B, 48).
    bx, by, bz = (points[:, i].to(pz.dtype)[None, :] for i in range(3))
    cap = torch.zeros(N_CANDIDATES, dtype=torch.bool, device=pz.device)
    cap[8:16] = True
    rwx = col(r00) * bx + col(r01) * by + col(r02) * bz
    rwy = col(r10) * bx + col(r11) * by + col(r12) * bz
    rwz = col(r20) * bx + col(r21) * by + col(r22) * bz
    rwx = torch.where(cap, rwx + col(c["cap_r"] * uwx), rwx)
    rwy = torch.where(cap, rwy + col(c["cap_r"] * uwy), rwy)
    rwz = torch.where(cap, rwz + col(c["cap_r"] * uwz), rwz)
    zc = col(pz) + rwz
    active = zc < 0.0
    any_active = active.any(dim=1)
    wide = active[:, N_SMALL:].any(dim=1) | (any_active & force48)
    tier = any_active.long() + wide.long()
    if not bool(any_active.any()):
        return force, torque, tier
    pen = -zc
    mzz = 0.5 * (rwz - col(pz))
    rbx = col(r00) * rwx + col(r10) * rwy + col(r20) * mzz
    rby = col(r01) * rwx + col(r11) * rwy + col(r21) * mzz
    rbz = col(r02) * rwx + col(r12) * rwy + col(r22) * mzz
    rhx, rhy, rhz = rbx, rby, rbz - cz
    # v_pt = vel + R (omega x r_b); a_pt0 = a_o0 + R (alpha0 x r_b).
    cbx = col(oy) * rbz - col(oz) * rby
    cby = col(oz) * rbx - col(ox) * rbz
    cbz = col(ox) * rby - col(oy) * rbx
    vpx = col(vx) + col(r00) * cbx + col(r01) * cby + col(r02) * cbz
    vpy = col(vy) + col(r10) * cbx + col(r11) * cby + col(r12) * cbz
    vpz = col(vz) + col(r20) * cbx + col(r21) * cby + col(r22) * cbz
    abx = col(al0y) * rbz - col(al0z) * rby
    aby = col(al0z) * rbx - col(al0x) * rbz
    abz = col(al0x) * rby - col(al0y) * rbx
    apx = col(aox) + col(r00) * abx + col(r01) * aby + col(r02) * abz
    apy = col(aoy) + col(r10) * abx + col(r11) * aby + col(r12) * abz
    apz = col(aoz) + col(r20) * abx + col(r21) * aby + col(r22) * abz
    d = _impedance(pen)
    dKpen = d * _CONTACT_K * pen
    Ri = (1.0 - d) / d * c["kappa"]
    # Arms rho x (R^T e): nb / t1b are rows 2 / 1 of R, t2b is -row 0.
    aN = (rhy * col(r22) - rhz * col(r21), rhz * col(r20) - rhx * col(r22),
          rhx * col(r21) - rhy * col(r20))
    aT1 = (rhy * col(r12) - rhz * col(r11), rhz * col(r10) - rhx * col(r12),
           rhx * col(r11) - rhy * col(r10))
    aT2 = (rhz * col(r01) - rhy * col(r02), rhx * col(r02) - rhz * col(r00),
           rhy * col(r00) - rhx * col(r01))
    # The b rows decompose as P +- mu Q_j.
    P = apz - dKpen + _CONTACT_B * vpz
    Q1 = apy + _CONTACT_B * vpy
    Q2 = -(apx + _CONTACT_B * vpx)
    arms, bs, rds = [], [], []
    for tj, s in _STAGES:
        aT, Q = (aT1, Q1) if tj == 1 else (aT2, Q2)
        arm = tuple(aN[i] + s * mu * aT[i] for i in range(3))
        diag = (c["ee_inv_m"] + arm[0] * arm[0] * c["inv_ix"] + arm[1] * arm[1] * c["inv_iy"]
                + arm[2] * arm[2] * c["inv_iz"] + Ri)
        arms.append(arm)
        bs.append(P + s * mu * Q)
        rds.append(1.0 / diag)

    # The tiers: no arm corner below the plane -> the first 16 candidates.
    wrench = [torch.zeros_like(pz) for _ in range(6)]
    for rows, nc in ((any_active & ~wide, N_SMALL), (wide, N_CANDIDATES)):
        idx = torch.nonzero(rows).squeeze(1)
        if idx.numel() == 0:
            continue
        out = _sweep(c, active[idx, :nc], Ri[idx, :nc],
                     [tuple(a[idx, :nc] for a in arm) for arm in arms],
                     [b[idx, :nc] for b in bs], [r[idx, :nc] for r in rds])
        for total, part in zip(wrench, out):
            total[idx] = part
    Fx, Fy, Fz, Wx, Wy, Wz = wrench
    return ((fx + Fx, fy + Fy, fz + Fz),
            (tx + Wx * c["ix"], ty + Wy * c["iy"], tz + Wz * c["iz"]), tier)


def contact_substep(s: list, c: dict, points: torch.Tensor, force48: bool = False):
    """One semi-implicit Euler substep of the 13 state rows ``s`` with the
    coupled contact (``_rigid_substep`` with ``contact=True``): thrust and
    servo wrench, fluid drag, the contact solve on the unconstrained
    accelerations, the CoM-offset origin coupling, the exp-map quaternion.
    Returns the new rows and the tier each env's solve ran."""
    px, py, pz, qw, qx, qy, qz, vx, vy, vz, ox, oy, oz = s
    cz, dt = c["cz"], c["dt"]

    def div(a, b):
        return a / a.new_tensor(b)

    qn2 = qw * qw + qx * qx + qy * qy + qz * qz
    inv = 1.0 / qn2
    r00 = 1.0 - 2.0 * (qy * qy + qz * qz) * inv
    r01 = 2.0 * (qx * qy - qz * qw) * inv
    r02 = 2.0 * (qx * qz + qy * qw) * inv
    r10 = 2.0 * (qx * qy + qz * qw) * inv
    r11 = 1.0 - 2.0 * (qx * qx + qz * qz) * inv
    r12 = 2.0 * (qy * qz - qx * qw) * inv
    r20 = 2.0 * (qx * qz - qy * qw) * inv
    r21 = 2.0 * (qy * qz + qx * qw) * inv
    r22 = 1.0 - 2.0 * (qx * qx + qy * qy) * inv

    fx = r02 * c["total"]
    fy = r12 * c["total"]
    fz = r22 * c["total"] + c["gm"]
    tx, ty, tz = (torch.full_like(px, c[k]) for k in ("mx", "my", "mz"))
    if c["servo"]:
        tx = tx + c["servo_kv"] * (c["cmd0"] - ox)
        ty = ty + c["servo_kv"] * (c["cmd1"] - oy)
        tz = tz + c["servo_kv"] * (c["cmd2"] - oz)

    # Fluid drag (body frame): v_com_b = R^T v + omega x c, c = (0, 0, cz).
    vb0 = r00 * vx + r10 * vy + r20 * vz + oy * cz
    vb1 = r01 * vx + r11 * vy + r21 * vz - ox * cz
    vb2 = r02 * vx + r12 * vy + r22 * vz
    fb0 = -c["kv"] * vb0 - c["fdx"] * torch.abs(vb0) * vb0
    fb1 = -c["kv"] * vb1 - c["fdy"] * torch.abs(vb1) * vb1
    fb2 = -c["kv"] * vb2 - c["fdz"] * torch.abs(vb2) * vb2
    tx = tx - c["kt"] * ox - c["tdx"] * torch.abs(ox) * ox
    ty = ty - c["kt"] * oy - c["tdy"] * torch.abs(oy) * oy
    tz = tz - c["kt"] * oz - c["tdz"] * torch.abs(oz) * oz
    fx = fx + r00 * fb0 + r01 * fb1 + r02 * fb2
    fy = fy + r10 * fb0 + r11 * fb1 + r12 * fb2
    fz = fz + r20 * fb0 + r21 * fb1 + r22 * fb2

    # Gyroscopic term omega x (I omega).
    ix, iy, iz = c["ix"], c["iy"], c["iz"]
    gyx = oy * (iz * oz) - oz * (iy * oy)
    gyy = oz * (ix * ox) - ox * (iz * oz)
    gyz = ox * (iy * oy) - oy * (ix * ox)

    (fx, fy, fz), (tx, ty, tz), tier = coupled_contact(
        c, points, (px, py, pz), (r00, r01, r02, r10, r11, r12, r20, r21, r22), (vx, vy, vz),
        (ox, oy, oz), (fx, fy, fz), (tx, ty, tz), (gyx, gyy, gyz), force48)

    odx = div(tx - gyx, ix)
    ody = div(ty - gyy, iy)
    odz = div(tz - gyz, iz)
    # Origin coupling: a_o = a_c - R (alpha x c + omega x (omega x c)).
    uc0 = (ody + oz * ox) * cz
    uc1 = (-odx + oz * oy) * cz
    uc2 = -(ox * ox + oy * oy) * cz
    m = c["mass"]
    accx = div(fx, m) - (r00 * uc0 + r01 * uc1 + r02 * uc2)
    accy = div(fy, m) - (r10 * uc0 + r11 * uc1 + r12 * uc2)
    accz = div(fz, m) - (r20 * uc0 + r21 * uc1 + r22 * uc2)
    nvx, nvy, nvz = vx + accx * dt, vy + accy * dt, vz + accz * dt
    nox, noy, noz = ox + odx * dt, oy + ody * dt, oz + odz * dt

    # Exp-map quaternion update: q (x) exp(omega dt / 2), renormalised.
    rx, ry, rz = nox * dt, noy * dt, noz * dt
    ang = torch.sqrt(rx * rx + ry * ry + rz * rz)
    half = 0.5 * ang
    big = ang > 1e-9
    sinc_half = torch.where(big, torch.sin(half) / torch.where(big, ang, 1.0), 0.5)
    dw = torch.cos(half)
    ex, ey, ez = rx * sinc_half, ry * sinc_half, rz * sinc_half
    mqw = qw * dw - qx * ex - qy * ey - qz * ez
    mqx = qw * ex + qx * dw + qy * ez - qz * ey
    mqy = qw * ey - qx * ez + qy * dw + qz * ex
    mqz = qw * ez + qx * ey - qy * ex + qz * dw
    inv_n = torch.rsqrt(mqw * mqw + mqx * mqx + mqy * mqy + mqz * mqz)
    return [px + nvx * dt, py + nvy * dt, pz + nvz * dt, mqw * inv_n, mqx * inv_n, mqy * inv_n,
            mqz * inv_n, nvx, nvy, nvz, nox, noy, noz], tier


def near_plane(states_t: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """The envs of ``(13, B)`` states with a contact candidate within
    ``eps`` of the plane, ``(B,)`` bool: the knife edge of the active test
    ``z < 0``, where a last-bit difference switches a candidate."""
    from ..envs import tpuquad
    from . import quadmath as qm

    s = states_t.T
    rot = qm.quat_to_rotmat(qm.quat_normalize(s[:, 3:7]))
    return (tpuquad.candidate_z(s[:, 0:3], rot).abs() < eps).any(dim=1)


def _consts(params: torch.Tensor):
    """The params vector as Python floats by name, and the ``(48, 3)``
    candidate points."""
    values = params.tolist()
    c = dict(zip(SCALAR_FIELDS, values))
    return c, params[len(SCALAR_FIELDS):].reshape(N_CANDIDATES, 3)


def _check_args(states_t, horizon, frame_skip, params_vec, dtypes) -> torch.Tensor:
    """Validate what the kernel takes; returns the params vector."""
    if not isinstance(states_t, torch.Tensor) or states_t.dtype not in dtypes:
        raise TypeError(f"states_t must be a tensor of {' or '.join(map(str, dtypes))}")
    if states_t.dim() != 2 or states_t.shape[0] != D or states_t.shape[1] == 0:
        raise ValueError(f"states_t must be ({D}, B) with B > 0, got {tuple(states_t.shape)}")
    if not states_t.is_contiguous():
        raise ValueError("states_t must be contiguous")
    if not 0 <= int(horizon) < 2**31:
        raise ValueError(f"horizon must be in [0, 2**31), got {horizon}")
    if not 1 <= int(frame_skip) < 2**31:
        raise ValueError(f"frame_skip must be a positive int, got {frame_skip}")
    params = contact_params_vec(dtype=states_t.dtype) if params_vec is None else params_vec
    if params.shape != (N_PARAMS,):
        raise ValueError(f"params_vec must be ({N_PARAMS},), got {tuple(params.shape)}")
    return params.detach().to("cpu")


def contact_rollout_reference(states_t: torch.Tensor, horizon: int,
                              params_vec: torch.Tensor | None = None, frame_skip: int = 2,
                              force48: bool = False, record_tiers: bool = False):
    """Plain PyTorch twin of K11, on any device, in the states' dtype
    (float32: the kernel's arithmetic in its order; float64: held to the
    env's solve, with a float64 ``params_vec``).  Same arguments and
    returns as :func:`contact_rollout`."""
    params = _check_args(states_t, horizon, frame_skip, params_vec,
                         (torch.float32, torch.float64))
    c, points = _consts(params)
    points = points.to(device=states_t.device, dtype=states_t.dtype)
    s = list(states_t.clone().unbind(0))
    z_sum = torch.zeros_like(s[0])
    tiers = torch.zeros((s[0].shape[0], 3), dtype=torch.int32, device=states_t.device)
    reset = [0.0, 0.0, c["init_z"], 1.0] + [0.0] * 9
    for _ in range(int(horizon)):
        for _ in range(int(frame_skip)):
            s, tier = contact_substep(s, c, points, force48)
            tiers += torch.nn.functional.one_hot(tier, 3).to(torch.int32)
        total = s[0]
        for x in s[1:]:
            total = total + x
        bad = ~torch.isfinite(total)
        z_sum = z_sum + s[2]
        s = [torch.where(bad, v, x) for v, x in zip(reset, s)]
    if record_tiers:
        return torch.stack(s), z_sum, tiers
    return torch.stack(s), z_sum


def contact_rollout(states_t: torch.Tensor, horizon: int, params_vec: torch.Tensor | None = None,
                    frame_skip: int = 2, force48: bool = False, record_tiers: bool = False):
    """K11: ``horizon`` steps of MujocoQuadForce-v0 or MujocoQuadQuat-v0
    (the model and the constant action are in ``params_vec``) in one CUDA
    launch.

    ``states_t``: ``(13, B)`` float32, contiguous, any ``B > 0``.
    ``params_vec``: :func:`contact_params_vec` output (the force model's
    defaults under the zero action when None); ``frame_skip`` substeps per
    step.  ``force48`` sweeps all 48 candidates in every env in contact (for
    the check that the 16-candidate tier is bitwise the same).  Returns
    ``(final (13, B), z_sum (B,))``, float32: Σz over the steps, before the
    non-finite reset; with ``record_tiers=True`` also ``(B, 3)`` int32
    counts of the substeps that ran no solve, the 16- and the 48-candidate
    sweep.  Launches on the current stream and does not synchronise.  A CPU
    tensor runs the plain twin; a CUDA tensor runs the kernel or raises.
    """
    params = _check_args(states_t, horizon, frame_skip, params_vec, (torch.float32,)).float()
    if states_t.device.type == "cpu":
        return contact_rollout_reference(states_t, horizon, params, frame_skip, force48,
                                         record_tiers)
    if states_t.device.type != "cuda":
        raise ValueError(f"unsupported device {states_t.device}")
    from .._build import check, load_library

    lib = load_library()
    batch = states_t.shape[1]
    final = torch.empty_like(states_t)
    z_sum = torch.empty(batch, dtype=torch.float32, device=states_t.device)
    tiers = (torch.empty((batch, 3), dtype=torch.int32, device=states_t.device)
             if record_tiers else None)
    host_params = (ctypes.c_float * N_PARAMS)(*params.tolist())
    with torch.cuda.device(states_t.device):
        rc = lib.contact_rollout_launch(
            states_t.data_ptr(), final.data_ptr(), z_sum.data_ptr(),
            None if tiers is None else tiers.data_ptr(), batch, int(horizon),
            int(frame_skip), int(_PGS_ITERS), int(force48), ctypes.addressof(host_params),
            N_PARAMS, torch.cuda.current_stream().cuda_stream)
    check(rc, "contact_rollout_launch")
    contact_rollout.launches += 1
    return (final, z_sum, tiers) if record_tiers else (final, z_sum)


#: Kernel launches so far (a run can show that its path went through K11).
contact_rollout.launches = 0
