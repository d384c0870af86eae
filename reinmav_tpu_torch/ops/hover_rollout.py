"""Kernel K5: the hover task's constant-action throughput rollout, and its
plain twin; and the hover step's arithmetic that K6-hover shares.

The counterpart of :mod:`reinmav_tpu.ops.pallas_tpuquad`'s hover kernel
(``hover_rollout_pallas8``).  :func:`hover_rollout` runs the whole
horizon of MujocoQuadForce-v1 under a constant raw action (``frame_skip``
substeps per step, the hovering reward, the deterministic auto-reset) in
one CUDA kernel written by hand for Hopper (``csrc/hover_rollout.cu``,
with the step in ``csrc/hover_common.cuh``) on a ``(13, B)`` float32
state.  :func:`hover_rollout_reference` is its plain PyTorch twin: the
TPU kernel's component arithmetic (which differs from the env's matrix
form in :mod:`reinmav_tpu_torch.envs.tpuquad` only in rounding), in the
kernel's order.

The wrapper takes the twin only for a tensor that lies on the CPU; on a
CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

#: hover_params_vec's order (the JAX package's pallas_tpuquad.hover_params_vec).
HOVER_FIELDS = ("mass", "ix", "iy", "iz", "com_z", "gravity", "dt", "init_z", "arm_xy",
                "yaw_gear", "ctrl_high", "contact_friction", "density", "viscosity", "dx", "dy",
                "dz")
D = 13


def hover_params_vec(p=None) -> torch.Tensor:
    """``envs.tpuquad.Params`` (the hover defaults, ``init_z=1``, when None)
    -> the kernels' ``(17,)`` float32 CPU vector in :data:`HOVER_FIELDS`
    order.  Params of another type raise rather than mis-wire a constant."""
    from ..envs.tpuquad import Params

    p = Params(init_z=1.0) if p is None else p
    if type(p) is not Params:
        raise ValueError(f"hover params must be envs.tpuquad.Params, got {type(p).__name__}")
    return torch.tensor([p.mass, *p.inertia_diag, p.com_z, p.gravity, p.dt, p.init_z, p.arm_xy,
                         p.yaw_gear, p.ctrl_high, p.contact_friction, p.density, p.viscosity,
                         *p.box_dims], dtype=torch.float32)


def _f32(x) -> float:
    return float(np.float32(x))


def hover_consts(params_vec: torch.Tensor) -> dict:
    """The params as float32 scalars by name, with the fluid-drag constants
    formed as the kernels' ``hover_drag`` forms them (csrc/hover_common.cuh,
    each product and sum rounded to float32)."""
    c = dict(zip(HOVER_FIELDS, (np.float32(v) for v in params_vec.tolist())))
    f = np.float32
    diam = (c["dx"] + c["dy"] + c["dz"]) / f(3.0)
    diam3 = diam * (diam * diam)
    dx4, dy4, dz4 = ((c[n] * c[n]) * (c[n] * c[n]) for n in ("dx", "dy", "dz"))
    half_rho = f(0.5) * c["density"]
    out = {k: float(v) for k, v in c.items()}
    out.update(
        kv=_f32((f(3.0 * math.pi) * c["viscosity"]) * diam),
        kt=_f32((f(math.pi) * c["viscosity"]) * diam3),
        fx=_f32((half_rho * c["dy"]) * c["dz"]), fy=_f32((half_rho * c["dz"]) * c["dx"]),
        fz=_f32((half_rho * c["dx"]) * c["dy"]),
        tx=_f32((c["density"] * c["dx"]) * (dy4 + dz4) / f(64.0)),
        ty=_f32((c["density"] * c["dy"]) * (dz4 + dx4) / f(64.0)),
        tz=_f32((c["density"] * c["dz"]) * (dx4 + dy4) / f(64.0)))
    return out


def hover_wrench(a, c: dict):
    """The motor wrench ``(total, mx, my, mz)`` of raw actions ``a`` (four
    tensors or floats), as the kernels' ``hover_wrench``."""
    u = [torch.clamp(torch.as_tensor(x, dtype=torch.float32), min=0.0).clamp(max=c["ctrl_high"])
         for x in a]
    total = ((u[0] + u[1]) + u[2]) + u[3]
    mx = c["arm_xy"] * (((u[0] - u[1]) - u[2]) + u[3])
    my = -c["arm_xy"] * (((u[0] + u[1]) - u[2]) - u[3])
    mz = c["yaw_gear"] * (((-u[0] + u[1]) - u[2]) + u[3])
    return total, mx, my, mz


def hover_substep(s: list, c: dict, wrench) -> list:
    """One substep of the 13 state rows ``s`` under ``wrench``, as the
    kernels' ``hover_substep`` (csrc/hover_common.cuh) computes it."""
    px, py, pz, qw, qx, qy, qz, vx, vy, vz, ox, oy, oz = s
    total, mx, my, mz = wrench
    cz, dt = c["com_z"], c["dt"]
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

    fx = r02 * total
    fy = r12 * total
    fz = r22 * total + _f32(np.float32(c["gravity"]) * np.float32(c["mass"]))

    vb0 = r00 * vx + r10 * vy + r20 * vz + oy * cz
    vb1 = r01 * vx + r11 * vy + r21 * vz - ox * cz
    vb2 = r02 * vx + r12 * vy + r22 * vz
    fb0 = -c["kv"] * vb0 - c["fx"] * torch.abs(vb0) * vb0
    fb1 = -c["kv"] * vb1 - c["fy"] * torch.abs(vb1) * vb1
    fb2 = -c["kv"] * vb2 - c["fz"] * torch.abs(vb2) * vb2
    tx = mx - c["kt"] * ox - c["tx"] * torch.abs(ox) * ox
    ty = my - c["kt"] * oy - c["ty"] * torch.abs(oy) * oy
    tz = mz - c["kt"] * oz - c["tz"] * torch.abs(oz) * oz
    fx = fx + r00 * fb0 + r01 * fb1 + r02 * fb2
    fy = fy + r10 * fb0 + r11 * fb1 + r12 * fb2
    fz = fz + r20 * fb0 + r21 * fb1 + r22 * fb2

    ix, iy, iz = c["ix"], c["iy"], c["iz"]
    gyx = oy * (iz * oz) - oz * (iy * oy)
    gyy = oz * (ix * ox) - ox * (iz * oz)
    gyz = ox * (iy * oy) - oy * (ix * ox)
    odx = (tx - gyx) / ix
    ody = (ty - gyy) / iy
    odz = (tz - gyz) / iz
    uc0 = (ody + oz * ox) * cz
    uc1 = (-odx + oz * oy) * cz
    uc2 = -(ox * ox + oy * oy) * cz
    m = c["mass"]
    accx = fx / m - (r00 * uc0 + r01 * uc1 + r02 * uc2)
    accy = fy / m - (r10 * uc0 + r11 * uc1 + r12 * uc2)
    accz = fz / m - (r20 * uc0 + r21 * uc1 + r22 * uc2)

    nvx, nvy, nvz = vx + accx * dt, vy + accy * dt, vz + accz * dt
    nox, noy, noz = ox + odx * dt, oy + ody * dt, oz + odz * dt

    rx, ry, rz = nox * dt, noy * dt, noz * dt
    ang = torch.sqrt(rx * rx + ry * ry + rz * rz)
    half = 0.5 * ang
    big = ang > _f32(1e-9)
    sinc_half = torch.where(big, torch.sin(half) / torch.where(big, ang, torch.ones_like(ang)),
                            torch.full_like(ang, 0.5))
    dw = torch.cos(half)
    ex, ey, ez = rx * sinc_half, ry * sinc_half, rz * sinc_half
    mqw = qw * dw - qx * ex - qy * ey - qz * ez
    mqx = qw * ex + qx * dw + qy * ez - qz * ey
    mqy = qw * ey - qx * ez + qy * dw + qz * ex
    mqz = qw * ez + qx * ey - qy * ex + qz * dw
    inv_n = torch.rsqrt(mqw * mqw + mqx * mqx + mqy * mqy + mqz * mqz)
    return [px + nvx * dt, py + nvy * dt, pz + nvz * dt, mqw * inv_n, mqx * inv_n, mqy * inv_n,
            mqz * inv_n, nvx, nvy, nvz, nox, noy, noz]


def hover_reward_done(s: list):
    """``(-10 P - 0.1 V, done)`` of the 13 state rows: the hovering
    reward's state terms (the caller adds ``- |a|^2 + 0.1 sum(a) + 100``)
    and done = not finite, z <= 0.3, |x| >= 2 or |y| >= 2."""
    px, py, pz = s[0], s[1], s[2]
    vel_sq = s[7] * s[7]
    for x in s[8:13]:
        vel_sq = vel_sq + x * x
    total = s[0]
    for x in s[1:]:
        total = total + x
    dz = pz - 1.0
    done = ~torch.isfinite(total) | (pz <= _f32(0.3)) | (torch.abs(px) >= 2.0) | (torch.abs(py) >= 2.0)
    return -10.0 * (px * px + py * py + dz * dz) - _f32(0.1) * vel_sq, done


def _check_args(states_t, horizon, frame_skip, action, params_vec) -> torch.Tensor:
    """Validate what the kernel takes; returns the (17,) params vector."""
    if not isinstance(states_t, torch.Tensor) or states_t.dtype != torch.float32:
        raise TypeError("states_t must be a float32 tensor")
    if states_t.dim() != 2 or states_t.shape[0] != D or states_t.shape[1] == 0:
        raise ValueError(f"states_t must be ({D}, B) with B > 0, got {tuple(states_t.shape)}")
    if not states_t.is_contiguous():
        raise ValueError("states_t must be contiguous")
    if not 0 <= int(horizon) < 2**31:
        raise ValueError(f"horizon must be in [0, 2**31), got {horizon}")
    if not 1 <= int(frame_skip) < 2**31:
        raise ValueError(f"frame_skip must be a positive int, got {frame_skip}")
    if len(action) != 4:
        raise ValueError(f"action must be 4 raw controls, got {action}")
    params = hover_params_vec() if params_vec is None else params_vec
    if params.shape != (len(HOVER_FIELDS),):
        raise ValueError(f"params_vec must be ({len(HOVER_FIELDS)},), got {tuple(params.shape)}")
    return params.detach().to("cpu", torch.float32)


def _action_consts(action):
    """``(a_sq, 0.1 * a_sum)`` of the constant raw action, in float64 and
    then float32, as the TPU kernel folds its Python constants."""
    a = [float(x) for x in action]
    return _f32(sum(x * x for x in a)), _f32(0.1 * sum(a))


def hover_rollout_reference(states_t: torch.Tensor, horizon: int,
                            action=(0.0, 0.0, 0.0, 0.0), params_vec: torch.Tensor | None = None,
                            frame_skip: int = 2):
    """Plain PyTorch twin of K5, on any device: the same float32 arithmetic
    in the same order.  Returns ``(final (13, B), reward_sum (B,))``."""
    params = _check_args(states_t, horizon, frame_skip, action, params_vec)
    c = hover_consts(params)
    a_sq, a_sum01 = _action_consts(action)
    wrench = tuple(float(x) for x in hover_wrench([_f32(a) for a in action], c))
    s = list(states_t.clone().unbind(0))
    reward_sum = torch.zeros_like(s[0])
    reset = torch.tensor([0.0, 0.0, c["init_z"], 1.0] + [0.0] * 9, dtype=torch.float32,
                         device=states_t.device)
    for _ in range(int(horizon)):
        for _ in range(int(frame_skip)):
            s = hover_substep(s, c, wrench)
        terms, done = hover_reward_done(s)
        reward_sum = reward_sum + (((terms - a_sq) + a_sum01) + 100.0)
        s = [torch.where(done, reset[d], x) for d, x in enumerate(s)]
    return torch.stack(s), reward_sum


def hover_rollout(states_t: torch.Tensor, horizon: int, action=(0.0, 0.0, 0.0, 0.0),
                  params_vec: torch.Tensor | None = None, frame_skip: int = 2):
    """K5: ``horizon`` steps of MujocoQuadForce-v1 under the constant raw
    ``action`` with deterministic auto-reset, in one CUDA launch.

    ``states_t``: ``(13, B)`` float32, contiguous, any ``B > 0``.
    ``params_vec``: :func:`hover_params_vec` output (the hover defaults
    when None); ``frame_skip`` substeps per step.  Returns ``(final (13,
    B), reward_sum (B,))``, float32.  Launches on the current stream and
    does not synchronise.  A CPU tensor runs the plain twin; a CUDA tensor
    runs the kernel or raises.
    """
    params = _check_args(states_t, horizon, frame_skip, action, params_vec)
    if states_t.device.type == "cpu":
        return hover_rollout_reference(states_t, horizon, action, params, frame_skip)
    if states_t.device.type != "cuda":
        raise ValueError(f"unsupported device {states_t.device}")
    from .._build import check, load_library

    lib = load_library()
    batch = states_t.shape[1]
    final = torch.empty_like(states_t)
    reward_sum = torch.empty(batch, dtype=torch.float32, device=states_t.device)
    host_params = (ctypes.c_float * len(HOVER_FIELDS))(*params.tolist())
    host_action = (ctypes.c_float * 4)(*(float(a) for a in action))
    a_sq, a_sum01 = _action_consts(action)
    with torch.cuda.device(states_t.device):
        rc = lib.hover_rollout_launch(
            states_t.data_ptr(), final.data_ptr(), reward_sum.data_ptr(), batch, int(horizon),
            int(frame_skip), ctypes.addressof(host_params), ctypes.addressof(host_action), a_sq,
            a_sum01, torch.cuda.current_stream().cuda_stream)
    check(rc, "hover_rollout_launch")
    hover_rollout.launches += 1
    return final, reward_sum


#: Kernel launches so far (a run can show that its path went through K5).
hover_rollout.launches = 0
