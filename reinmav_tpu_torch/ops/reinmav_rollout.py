"""Kernel K10: the reinmav-v0 rollout, and its plain twin.

The counterpart of :func:`reinmav_tpu.ops.pallas_reinmav.reinmav_rollout_pallas8`.
:func:`reinmav_rollout` runs ``horizon`` outer steps of ``reinmav-v0``
(each a masked loop of 51 controller-in-the-loop Euler substeps, 50 or 51
of them live) in one launch of a CUDA kernel written by hand for Hopper
(``csrc/reinmav_rollout.cu``) on a ``(14, B)`` float32 state: the 13
physical states and the simulation time.  The env has no action, no
reward but the constant 90 and no reset (PARITY.md Q9), so the kernel
returns the final states only.

:func:`reinmav_rollout_reference` is its plain PyTorch twin: the TPU
kernel's component arithmetic (``pallas_reinmav._substep``), which differs
from the env's matrix form in :mod:`reinmav_tpu_torch.envs.reinmav13` only
in rounding, with CUDA's own inverse trigonometry in place of the TPU
kernel's polynomials.  The kernel is built without FMA contraction, so the
twin's operations are the kernel's, one for one: the per-rotor clamp makes
the body-rate loop switch, and trajectories that part by one rounding grow
apart.  In particular the substep count and the substep times are rounded
as the kernel rounds them, so that kernel and twin live through the same
number of substeps in every step: a count that differs is a 0.2 ms shift
of simulated time.  Divisions by a constant divide by a tensor, never by a
Python number, which the card's PyTorch would turn into a product with the
reciprocal.

The params travel as the kernel's float32 vector
(:func:`reinmav_params_vec`): the env's fields and the constants derived
from them (the inverse inertia, the reciprocal mass, the mixer's
``0.5 / arm``, the trajectory's coefficients), derived in float64 on the
host, so that kernel and twin start from the same floats.

The wrapper takes the twin only for a tensor that lies on the CPU; on a
CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..envs.reinmav13 import Params, substep_count

D = 14
MAX_SUBSTEPS = 51
#: The kernel's params vector, in the order ``csrc/reinmav_rollout.cu`` reads it.
KERNEL_FIELDS = (
    "mass", "gravity", "arm_length", "min_force4", "max_force4", "dt", "ds", "inv_mass",
    "half_over_arm",
    *(f"i{r}{c}" for r in range(3) for c in range(3)),
    *(f"j{r}{c}" for r in range(3) for c in range(3)),  # the inverse inertia
    "kp0", "kp1", "kp2", "kd0", "kd1", "kd2", "kpr0", "kpr1", "kpr2", "kdr0", "kdr1", "kdr2",
    "t_max", "cv1", "cv2", "ca1", "ca2", "ca3", "k_quat")
#: The env Params fields the vector is derived from, in their order.
_PARAMS_FIELDS = ("mass", "gravity", "arm_length", "min_force", "max_force", "dt", "ds",
                  "inertia", "kp", "kd", "kp_rot", "kd_rot", "t_max", "k_quat")
_EPS = float(np.finfo(np.float64).eps)  # quat2mat's identity threshold


def reinmav_params_vec(p=None) -> torch.Tensor:
    """``envs.reinmav13.Params`` (the defaults when None) -> the kernel's
    float32 CPU vector in :data:`KERNEL_FIELDS` order, every derived
    constant computed in float64.  Params of another type or field order
    raise rather than mis-wire a constant."""
    p = Params() if p is None else p
    if type(p) is not Params or type(p)._fields != _PARAMS_FIELDS:
        raise ValueError(f"reinmav params must be envs.reinmav13.Params with fields "
                         f"{_PARAMS_FIELDS}, got {type(p).__name__}")
    inertia = np.asarray(p.inertia, np.float64)
    t = float(p.t_max)
    vec = [p.mass, p.gravity, p.arm_length, p.min_force / 4.0, p.max_force / 4.0, p.dt, p.ds,
           1.0 / p.mass, 0.5 / p.arm_length, *inertia.reshape(-1),
           *np.linalg.inv(inertia).reshape(-1), *p.kp, *p.kd, *p.kp_rot, *p.kd_rot, t,
           30.0 / t, 60.0 / t, 60.0 / t**2, 180.0 / t**2, 120.0 / t**2, p.k_quat]
    return torch.tensor([float(v) for v in vec], dtype=torch.float32)


def _consts(params: torch.Tensor) -> dict:
    """The params vector as Python floats by name (exact float32 values)."""
    return dict(zip(KERNEL_FIELDS, (float(v) for v in params.tolist())))


def substep_counts(t0: torch.Tensor, horizon: int, params_vec: torch.Tensor | None = None):
    """The live substep count of each of ``horizon`` steps from the times
    ``t0`` ``(B,)``, ``(horizon, B)`` uint8: ``ceil(((t + dt) - t) / ds)``
    with ``t += dt`` after each step, every operation in float32, as the
    kernel and the twin count."""
    c = _consts(reinmav_params_vec() if params_vec is None else params_vec)
    t = t0.to(torch.float32)
    dt, ds = t.new_tensor(c["dt"]), t.new_tensor(c["ds"])
    out = torch.empty((int(horizon), t.shape[0]), dtype=torch.uint8, device=t.device)
    for i in range(int(horizon)):
        out[i] = substep_count(t, dt, ds)
        t = t + dt
    return out


def reinmav_derivative(s: list, tk: torch.Tensor, c: dict) -> list:
    """The 13 state derivatives at the substep time ``tk`` (quat -> ZXY
    Euler, the quintic reference, the PD controller, the motor mixing with
    the per-rotor clamp and an unclamped Mz, the rigid-body EOM with the
    K_quat feedback), in the TPU kernel's order (``_substep``)."""
    x, y, z, vx, vy, vz, qw, qx, qy, qz, p_, q_, r_ = s

    def div(a, b):
        return a / a.new_tensor(b)

    nq = qw * qw + qx * qx + qy * qy + qz * qz
    valid = nq > _EPS
    s2 = torch.where(valid, torch.div(nq.new_tensor(2.0), torch.where(valid, nq, 1.0)), 0.0)
    X, Y, Z = qx * s2, qy * s2, qz * s2
    wX, wY, wZ = qw * X, qw * Y, qw * Z
    xX, xY, xZ = qx * X, qx * Y, qx * Z
    yY, yZ, zZ = qy * Y, qy * Z, qz * Z
    m02 = torch.where(valid, xZ + wY, 0.0)
    m10 = torch.where(valid, xY + wZ, 0.0)
    m11 = torch.where(valid, 1.0 - (xX + zZ), 1.0)
    m12 = torch.where(valid, yZ - wX, 0.0)
    m20 = torch.where(valid, xZ - wY, 0.0)
    m21 = torch.where(valid, yZ + wX, 0.0)
    m22 = torch.where(valid, 1.0 - (xX + yY), 1.0)

    # ZXY Euler extraction (reference RotToRPY); asin of |x| > 1 is NaN.
    phi = torch.asin(m12)
    cphi = torch.cos(phi)
    psi = torch.atan2(-m10 / cphi, m11 / cphi)
    theta = torch.atan2(-m02 / cphi, m22 / cphi)

    # The quintic min-jerk reference; yaw follows the same quintic.
    tc = div(torch.clamp(torch.clamp(tk, max=c["t_max"]), min=0.0), c["t_max"])
    tc2 = tc * tc
    tc3 = tc2 * tc
    pos_d = 10.0 * tc3 - 15.0 * tc3 * tc + 6.0 * tc3 * tc2
    vel_d = c["cv1"] * tc2 - c["cv2"] * tc3 + c["cv1"] * tc2 * tc2
    acc_d = c["ca1"] * tc - c["ca2"] * tc2 + c["ca3"] * tc3

    # The inner PD controller.
    ddr0 = acc_d + c["kd0"] * (vel_d - vx) + c["kp0"] * (pos_d - x)
    ddr1 = acc_d + c["kd1"] * (vel_d - vy) + c["kp1"] * (pos_d - y)
    ddr2 = acc_d + c["kd2"] * (vel_d - vz) + c["kp2"] * (pos_d - z)
    u1 = c["mass"] * (c["gravity"] + ddr2)
    sp, cp = torch.sin(pos_d), torch.cos(pos_d)
    phi_des = div(ddr0 * sp - ddr1 * cp, c["gravity"])
    theta_des = div(ddr0 * cp + ddr1 * sp, c["gravity"])
    mx = c["kpr0"] * (phi_des - phi) - c["kdr0"] * p_
    my = c["kpr1"] * (theta_des - theta) - c["kdr1"] * q_
    mz = c["kpr2"] * (pos_d - psi) + c["kdr2"] * (vel_d - r_)

    # Motor mixing: per-rotor clamp, Mz unclamped.
    h, lo, hi = c["half_over_arm"], c["min_force4"], c["max_force4"]
    t0 = torch.clamp(0.25 * u1 - h * my, lo, hi)
    t1 = torch.clamp(0.25 * u1 + h * mx, lo, hi)
    t2 = torch.clamp(0.25 * u1 + h * my, lo, hi)
    t3 = torch.clamp(0.25 * u1 - h * mx, lo, hi)
    total_f = t0 + t1 + t2 + t3
    mx_c = c["arm_length"] * (t1 - t3)
    my_c = c["arm_length"] * (t2 - t0)

    # wRb [0, 0, F] is row 2 of bRw scaled.
    ax = m20 * total_f * c["inv_mass"]
    ay = m21 * total_f * c["inv_mass"]
    az = m22 * total_f * c["inv_mass"] - c["gravity"]

    # The quaternion derivative with the K_quat norm feedback.
    k_err = c["k_quat"] * (1.0 - nq)
    qdw = -0.5 * (-p_ * qx - q_ * qy - r_ * qz) + k_err * qw
    qdx = -0.5 * (p_ * qw - r_ * qy + q_ * qz) + k_err * qx
    qdy = -0.5 * (q_ * qw + r_ * qx - p_ * qz) + k_err * qy
    qdz = -0.5 * (r_ * qw - q_ * qx + p_ * qy) + k_err * qz

    # Angular acceleration: invI (M - pqr x (I pqr)).
    ip = c["i00"] * p_ + c["i01"] * q_ + c["i02"] * r_
    iq = c["i10"] * p_ + c["i11"] * q_ + c["i12"] * r_
    ir = c["i20"] * p_ + c["i21"] * q_ + c["i22"] * r_
    rx = mx_c - (q_ * ir - r_ * iq)
    ry = my_c - (r_ * ip - p_ * ir)
    rz = mz - (p_ * iq - q_ * ip)
    pd = c["j00"] * rx + c["j01"] * ry + c["j02"] * rz
    qd = c["j10"] * rx + c["j11"] * ry + c["j12"] * rz
    rd = c["j20"] * rx + c["j21"] * ry + c["j22"] * rz
    return [vx, vy, vz, ax, ay, az, qdw, qdx, qdy, qdz, pd, qd, rd]


def _check_args(states_t, horizon, params_vec) -> torch.Tensor:
    """Validate what the kernel takes; returns the params vector."""
    if not isinstance(states_t, torch.Tensor) or states_t.dtype != torch.float32:
        raise TypeError("states_t must be a float32 tensor")
    if states_t.dim() != 2 or states_t.shape[0] != D or states_t.shape[1] == 0:
        raise ValueError(f"states_t must be ({D}, B) with B > 0, got {tuple(states_t.shape)}")
    if not states_t.is_contiguous():
        raise ValueError("states_t must be contiguous")
    if not 0 <= int(horizon) < 2**31:
        raise ValueError(f"horizon must be in [0, 2**31), got {horizon}")
    params = reinmav_params_vec() if params_vec is None else params_vec
    if params.shape != (len(KERNEL_FIELDS),):
        raise ValueError(f"params_vec must be ({len(KERNEL_FIELDS)},), got {tuple(params.shape)}")
    return params.detach().to("cpu", torch.float32)


def reinmav_rollout_reference(states_t: torch.Tensor, horizon: int,
                              params_vec: torch.Tensor | None = None,
                              record_substeps: bool = False):
    """Plain PyTorch twin of K10, on any device: the same float32 arithmetic
    in the same order.  Same arguments and returns as
    :func:`reinmav_rollout`."""
    params = _check_args(states_t, horizon, params_vec)
    c = _consts(params)
    s = list(states_t.clone().unbind(0))
    t = s[13]
    dt, ds = t.new_tensor(c["dt"]), t.new_tensor(c["ds"])
    counts = []
    for _ in range(int(horizon)):
        n_sub = substep_count(t, dt, ds)
        counts.append(n_sub.to(torch.uint8))
        s13 = s[:13]
        for k in range(MAX_SUBSTEPS):
            tk = t + float(np.float32(k) * np.float32(c["ds"]))
            live = k < n_sub
            sdot = reinmav_derivative(s13, tk, c)
            s13 = [torch.where(live, x + c["ds"] * d, x) for x, d in zip(s13, sdot)]
        t = t + dt
        s = s13 + [t]
    final = torch.stack(s)
    if record_substeps:
        return final, (torch.stack(counts) if counts else
                       torch.empty((0, final.shape[1]), dtype=torch.uint8, device=final.device))
    return final


def reinmav_rollout(states_t: torch.Tensor, horizon: int, params_vec: torch.Tensor | None = None,
                    record_substeps: bool = False):
    """K10: ``horizon`` steps of reinmav-v0 (no action, no reset) in one CUDA
    launch.

    ``states_t``: ``(14, B)`` float32, contiguous, any ``B > 0`` (the 13
    states and the simulation time).  ``params_vec``:
    :func:`reinmav_params_vec` output (the defaults when None).  Returns
    the final ``(14, B)`` float32 states; with ``record_substeps=True``
    also the live substep count of every step and env, ``(horizon, B)``
    uint8.  Launches on the current stream and does not synchronise.  A
    CPU tensor runs the plain twin; a CUDA tensor runs the kernel or
    raises.
    """
    params = _check_args(states_t, horizon, params_vec)
    if states_t.device.type == "cpu":
        return reinmav_rollout_reference(states_t, horizon, params, record_substeps)
    if states_t.device.type != "cuda":
        raise ValueError(f"unsupported device {states_t.device}")
    from .._build import check, load_library

    lib = load_library()
    batch = states_t.shape[1]
    final = torch.empty_like(states_t)
    counts = (torch.empty((int(horizon), batch), dtype=torch.uint8, device=states_t.device)
              if record_substeps else None)
    host_params = (ctypes.c_float * len(KERNEL_FIELDS))(*params.tolist())
    with torch.cuda.device(states_t.device):
        rc = lib.reinmav_rollout_launch(
            states_t.data_ptr(), final.data_ptr(), None if counts is None else counts.data_ptr(),
            batch, int(horizon), ctypes.addressof(host_params), len(KERNEL_FIELDS),
            torch.cuda.current_stream().cuda_stream)
    check(rc, "reinmav_rollout_launch")
    reinmav_rollout.launches += 1
    return (final, counts) if record_substeps else final


#: Kernel launches so far (a run can show that its path went through K10).
reinmav_rollout.launches = 0
