"""Kernels K8 and K9: the closed-loop rollouts of quadrotor2d-v0 and of the
two slung-load envs, and their plain twin.

The counterpart of :func:`reinmav_tpu.ops.pallas_rollout.component_rollout`
with the steps of ``quad2d_rollout_autoreset_pallas8`` (K8) and of
``pallas_slungload.slung2d_rollout_pallas8`` / ``slung3d_rollout_pallas8``
(K9).  :func:`closed_loop_rollout` runs the whole horizon of controller +
dynamics + auto-reset in one launch of a CUDA kernel written by hand for
Hopper (``csrc/closed_loop_rollout.cu``, a template on the env structs of
``csrc/env_kinds.cuh``) on a ``(D, B)`` float32 state.
:func:`closed_loop_rollout_reference` is its plain PyTorch twin: the same
arithmetic in the same order, and the same Philox4x32-10 reset draws as
K1 (:func:`reinmav_tpu_torch.ops.rollout.reset_draws`, stream 0).

K8/K9 run the TPU kernels' own steps (``_quad2d_step_tiles``,
``_slung2d_step_tiles``, ``_slung3d_step_tiles``): products with 1 / mass,
done on squared norms, one branch-free tether body; their twins are
:data:`LOOP_STEPS`.  This module also holds the three envs' controllers and
the policy kernels' steps (:data:`KINDS`), which the twins of K6
(:mod:`reinmav_tpu_torch.ops.ppo_rollout`) and K7 reuse, as those kernels
share the env structs of ``csrc/env_kinds.cuh``.  The slung-load step's
taut branch parks the load on the tether sphere, where a last-bit
difference selects the other branch next step: kernel and twin agree step
by step away from the sphere, and free-running trajectories part on it.

The wrapper takes the twin only for a tensor that lies on the CPU; on a
CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import math
from typing import Callable, NamedTuple

import numpy as np
import torch

from .rollout import body_z, geometric_control, reset_draws

_HALF_PI = math.pi / 2  # float32(pi / 2) once it meets a float32 tensor

#: Params field orders, the order the kernels read them in (the envs'
#: Params; the JAX package's _Q2_FIELDS, _S2_FIELDS, _S3_FIELDS).
_Q2_FIELDS = ("mass", "dt", "gravity", "ref_x", "ref_z", "pos_limit", "vel_limit", "kp", "kv",
              "tau", "thrust_scale")
_S2_FIELDS = ("mass", "load_mass", "dt", "gravity", "tether_length", "pos_limit", "vel_limit",
              "ref_x", "ref_z", "kp", "kv", "tau")
_S3_FIELDS = ("mass", "load_mass", "dt", "gravity", "tether_length", "pos_limit", "vel_limit",
              "ref_x", "ref_y", "ref_z", "kp", "kv", "tau")


def _params_vec(p, params_type, fields) -> torch.Tensor:
    """Params (default when None) -> float32 CPU vector in kernel order; a
    field-order mismatch raises rather than mis-wiring a constant."""
    p = p or params_type()
    if type(p)._fields != fields:
        raise ValueError(f"params fields {type(p)._fields} != kernel table {fields}")
    return torch.tensor([float(v) for v in p], dtype=torch.float32)


def quad2d_params_vec(p=None) -> torch.Tensor:
    from ..envs.quadrotor2d import Params

    return _params_vec(p, Params, _Q2_FIELDS)


def slung2d_params_vec(p=None) -> torch.Tensor:
    from ..envs.quadrotor2d_slungload import Params

    return _params_vec(p, Params, _S2_FIELDS)


def slung3d_params_vec(p=None) -> torch.Tensor:
    from ..envs.quadrotor3d_slungload import Params

    return _params_vec(p, Params, _S3_FIELDS)


def _scalars(fields, params: torch.Tensor) -> dict:
    """The params vector as Python floats (exact float32 values), plus the
    kernels' derived constants computed in float32 as their ``consts()``."""
    p = dict(zip(fields, params.numpy()))
    c = {k: float(v) for k, v in p.items()}
    c["neg_inv_tau"] = float(np.float32(-1.0) / p["tau"])
    c["two_over_tau"] = float(np.float32(2.0) / p["tau"])
    c["half_dt"] = float(np.float32(0.5) * p["dt"])
    c["inv_m"] = float(np.float32(1.0) / p["mass"])
    c["pos_lim2"] = float(p["pos_limit"] * p["pos_limit"])
    c["vel_lim2"] = float(p["vel_limit"] * p["vel_limit"])
    if "load_mass" in p:
        c["inv_mml"] = float(np.float32(1.0) / (p["mass"] + p["load_mass"]))
    return c


def _safe_inv(n):
    return 1.0 / torch.where(n > 0.0, n, torch.ones_like(n))


# --- the envs in the kernels' arithmetic, on (D, B) states ----------------------


def pd2d_control(s: torch.Tensor, c: dict) -> torch.Tensor:
    """The planar PD controller of quad2d_common.cuh on ``(5 or more, B)``
    states: ``(2, B)`` ``[thrust_N, omega]``."""
    x, z, th, vx, vz = s[:5].unbind(0)
    dax = c["kp"] * (x - c["ref_x"]) + c["kv"] * vx
    daz = c["kp"] * (z - c["ref_z"]) + c["kv"] * vz + 9.8
    des_att = torch.atan2(daz, dax) - _HALF_PI
    w = c["neg_inv_tau"] * (th - des_att)
    return torch.stack([c["mass"] * torch.sqrt(dax * dax + daz * daz), w])


def quad2d_step(s: torch.Tensor, act: torch.Tensor, c: dict):
    """quad2d_common.cuh::quad2d_step: ``(new states, reward, done)``."""
    x, z, th, vx, vz = s.unbind(0)
    dt = c["dt"]
    tq = torch.clamp(c["thrust_scale"] * act[0], min=0.0) / c["mass"]
    hx, hz = torch.cos(th + _HALF_PI), torch.sin(th + _HALF_PI)
    ax = tq * hx
    az = tq * hz + c["gravity"]
    nx = x + vx * dt + 0.5 * ax * dt * dt
    nz = z + vz * dt + 0.5 * az * dt * dt
    nvx, nvz = vx + ax * dt, vz + az * dt
    pn = torch.sqrt(nx * nx + nz * nz)
    vn = torch.sqrt(nvx * nvx + nvz * nvz)
    done = (pn > c["pos_limit"]) | (vn > 10.0) | (vn > c["vel_limit"])
    reward = torch.where(done, torch.ones_like(pn), -pn)
    return torch.stack([nx, nz, th + act[1] * dt, nvx, nvz]), reward, done


def slung2d_step(s: torch.Tensor, act: torch.Tensor, c: dict):
    """slung_common.cuh::slung2d_step (velocity-first Euler), both branches
    computed and selected: ``(new states, reward, done)``."""
    x, z, th, vx, vz, lx, lz, lvx, lvz = s.unbind(0)
    thrust, w = act[0], act[1]
    dt, g, L, m = c["dt"], c["gravity"], c["tether_length"], c["mass"]
    hx, hz = torch.cos(th + _HALF_PI), torch.sin(th + _HALF_PI)
    tq = thrust / m
    tqx, tqz = tq * hx, tq * hz
    tx, tz = lx - x, lz - z
    tn = torch.sqrt(tx * tx + tz * tz)
    inv = _safe_inv(tn)
    ux, uz = tx * inv, tz * inv
    taut = tn >= L

    # ---- taut ----
    sc = m * L * (lvx * lvx + lvz * lvz)
    proj = ux * (thrust * hx - sc) + uz * (thrust * hz - sc)
    lax = c["inv_mml"] * (proj * ux)
    laz = c["inv_mml"] * (proj * uz) + g
    lvx_t, lvz_t = lvx + lax * dt, lvz + laz * dt
    lpx_t = lx + lvx_t * dt + 0.5 * lax * dt * dt
    lpz_t = lz + lvz_t * dt + 0.5 * laz * dt * dt
    dzg = laz - g
    tmag = c["load_mass"] * torch.sqrt(lax * lax + dzg * dzg)
    accx = tqx + (tmag * ux) / m
    accz = tqz + g + (tmag * uz) / m
    vx_t, vz_t = vx + accx * dt, vz + accz * dt
    px_t = x + vx_t * dt + 0.5 * accx * dt * dt
    pz_t = z + vz_t * dt + 0.5 * accz * dt * dt
    dx, dz = lpx_t - px_t, lpz_t - pz_t
    dinv = _safe_inv(torch.sqrt(dx * dx + dz * dz))
    ddx, ddz = dx * dinv, dz * dinv
    lx_t, lz_t = px_t + ddx * L, pz_t + ddz * L
    rad = (lvx_t - vx_t) * ddx + (lvz_t - vz_t) * ddz
    lvx_t, lvz_t = lvx_t - rad * ddx, lvz_t - rad * ddz

    # ---- slack ----
    lvz_s = lvz + g * dt
    lx_s = lx + lvx * dt
    lz_s = lz + lvz_s * dt + 0.5 * g * dt * dt
    accz_s = tqz + g
    vx_s, vz_s = vx + tqx * dt, vz + accz_s * dt
    px_s = x + vx_s * dt + 0.5 * tqx * dt * dt
    pz_s = z + vz_s * dt + 0.5 * accz_s * dt * dt

    sel = lambda a, b: torch.where(taut, a, b)  # noqa: E731
    npx, npz, nvx, nvz = sel(px_t, px_s), sel(pz_t, pz_s), sel(vx_t, vx_s), sel(vz_t, vz_s)
    nlx, nlz, nlvx, nlvz = sel(lx_t, lx_s), sel(lz_t, lz_s), sel(lvx_t, lvx), sel(lvz_t, lvz_s)
    lpn = torch.sqrt(nlx * nlx + nlz * nlz)
    lvn = torch.sqrt(nlvx * nlvx + nlvz * nlvz)
    done = (lpn > c["pos_limit"]) | (lvn > c["vel_limit"])
    reward = torch.where(done, torch.ones_like(lpn), -torch.sqrt(npx * npx + npz * npz))
    new = torch.stack([npx, npz, th + w * dt, nvx, nvz, nlx, nlz, nlvx, nlvz])
    return new, reward, done


def slung3d_control(s: torch.Tensor, c: dict) -> torch.Tensor:
    """The geometric controller on the quad part of ``(16, B)`` states."""
    thrust, wx, wy, wz, _ = geometric_control(s, c["kp"], c["kv"], c["ref_x"], c["ref_y"],
                                              c["ref_z"], c["gravity"], c["two_over_tau"])
    return torch.stack([thrust, wx, wy, wz])


def slung3d_step(s: torch.Tensor, act: torch.Tensor, c: dict):
    """slung_common.cuh::slung3d_step (position-first Euler), both branches
    computed and selected: ``(new states, reward, done)``."""
    px, py, pz, qw, qx, qy, qz, vx, vy, vz, lx, ly, lz, lvx, lvy, lvz = s.unbind(0)
    thrust, wx, wy, wz = act.unbind(0)
    dt, g, L, m = c["dt"], c["gravity"], c["tether_length"], c["mass"]
    inv_qn, bzx, bzy, bzz = body_z(s)
    tq = thrust / m
    tqx, tqy, tqz = tq * bzx, tq * bzy, tq * bzz
    tx, ty, tz = lx - px, ly - py, lz - pz
    tn = torch.sqrt(tx * tx + ty * ty + tz * tz)
    inv = _safe_inv(tn)
    ux, uy, uz = tx * inv, ty * inv, tz * inv
    taut = tn >= L

    # ---- taut ----
    sc = m * L * (lvx * lvx + lvy * lvy + lvz * lvz)
    proj = ux * (thrust * bzx - sc) + uy * (thrust * bzy - sc) + uz * (thrust * bzz - sc)
    lax = c["inv_mml"] * (proj * ux)
    lay = c["inv_mml"] * (proj * uy)
    laz = c["inv_mml"] * (proj * uz) + g
    lpx_t = lx + lvx * dt + 0.5 * lax * dt * dt
    lpy_t = ly + lvy * dt + 0.5 * lay * dt * dt
    lpz_t = lz + lvz * dt + 0.5 * laz * dt * dt
    lvx_t, lvy_t, lvz_t = lvx + lax * dt, lvy + lay * dt, lvz + laz * dt
    dzg = laz - g
    tmag = c["load_mass"] * torch.sqrt(lax * lax + lay * lay + dzg * dzg)
    accx = tqx + (tmag * ux) / m
    accy = tqy + (tmag * uy) / m
    accz = tqz + g + (tmag * uz) / m
    px_t = px + vx * dt + 0.5 * accx * dt * dt
    py_t = py + vy * dt + 0.5 * accy * dt * dt
    pz_t = pz + vz * dt + 0.5 * accz * dt * dt
    vx_t, vy_t, vz_t = vx + accx * dt, vy + accy * dt, vz + accz * dt
    dx, dy, dz = lpx_t - px_t, lpy_t - py_t, lpz_t - pz_t
    dinv = _safe_inv(torch.sqrt(dx * dx + dy * dy + dz * dz))
    ddx, ddy, ddz = dx * dinv, dy * dinv, dz * dinv
    lx_t, ly_t, lz_t = px_t + ddx * L, py_t + ddy * L, pz_t + ddz * L
    rad = (lvx_t - vx_t) * ddx + (lvy_t - vy_t) * ddy + (lvz_t - vz_t) * ddz
    lvx_t, lvy_t, lvz_t = lvx_t - rad * ddx, lvy_t - rad * ddy, lvz_t - rad * ddz

    # ---- slack ----
    lx_s, ly_s = lx + lvx * dt, ly + lvy * dt
    lz_s = lz + lvz * dt + 0.5 * g * dt * dt
    lvz_s = lvz + g * dt
    accz_s = tqz + g
    px_s = px + vx * dt + 0.5 * tqx * dt * dt
    py_s = py + vy * dt + 0.5 * tqy * dt * dt
    pz_s = pz + vz * dt + 0.5 * accz_s * dt * dt
    vx_s, vy_s, vz_s = vx + tqx * dt, vy + tqy * dt, vz + accz_s * dt

    sel = lambda a, b: torch.where(taut, a, b)  # noqa: E731
    npx, npy, npz = sel(px_t, px_s), sel(py_t, py_s), sel(pz_t, pz_s)
    nvx, nvy, nvz = sel(vx_t, vx_s), sel(vy_t, vy_s), sel(vz_t, vz_s)
    nlx, nly, nlz = sel(lx_t, lx_s), sel(ly_t, ly_s), sel(lz_t, lz_s)
    nlvx, nlvy, nlvz = sel(lvx_t, lvx), sel(lvy_t, lvy), sel(lvz_t, lvz_s)

    # The quaternion update of quadrotor3d (Q4).
    hdt = c["half_dt"]
    hw, hx, hy, hz = qw * inv_qn, qx * inv_qn, qy * inv_qn, qz * inv_qn
    nqw = qw + hdt * (-hx * wx - hy * wy - hz * wz)
    nqx = qx + hdt * (hw * wx + hy * wz - hz * wy)
    nqy = qy + hdt * (hw * wy - hx * wz + hz * wx)
    nqz = qz + hdt * (hw * wz + hx * wy - hy * wx)

    lpn = torch.sqrt(nlx * nlx + nly * nly + nlz * nlz)
    vn = torch.sqrt(nvx * nvx + nvy * nvy + nvz * nvz)
    done = (lpn > c["pos_limit"]) | (vn > c["vel_limit"])
    reward = torch.where(done, torch.ones_like(lpn), -lpn)
    new = torch.stack([npx, npy, npz, nqw, nqx, nqy, nqz, nvx, nvy, nvz,
                       nlx, nly, nlz, nlvx, nlvy, nlvz])
    return new, reward, done


# --- K8/K9's own steps, the TPU kernels' arithmetic, on (D, B) states ---------
# Each returns ``(new states, reward, done, counted)``: ``counted`` is what
# the kernel's optional counts add up, the taut tether at the start of the
# step for the slung kinds, ``done`` for quad2d.


def quad2d_loop_step(s: torch.Tensor, act: torch.Tensor, c: dict):
    """closed_loop_rollout.cu::Quad2dLoop::step (_quad2d_step_tiles)."""
    x, z, th, vx, vz = s.unbind(0)
    dt = c["dt"]
    tm = torch.clamp(c["thrust_scale"] * act[0], min=0.0) * c["inv_m"]
    hx, hz = torch.cos(th + _HALF_PI), torch.sin(th + _HALF_PI)
    ax = tm * hx
    az = tm * hz + c["gravity"]
    nx = x + vx * dt + 0.5 * ax * dt * dt
    nz = z + vz * dt + 0.5 * az * dt * dt
    nvx, nvz = vx + ax * dt, vz + az * dt
    pn2 = nx * nx + nz * nz
    vn2 = nvx * nvx + nvz * nvz
    done = (pn2 > c["pos_lim2"]) | (vn2 > 100.0) | (vn2 > c["vel_lim2"])
    reward = torch.where(done, torch.ones_like(pn2), -torch.sqrt(pn2))
    return torch.stack([nx, nz, th + act[1] * dt, nvx, nvz]), reward, done, done


def slung2d_loop_step(s: torch.Tensor, act: torch.Tensor, c: dict):
    """closed_loop_rollout.cu::Slung2dLoop::step (_slung2d_step_tiles,
    velocity-first Euler): the taut update once, the load's acceleration
    selected to (0, g) and the pull on the quad to 0 when slack, the
    projection selected."""
    x, z, th, vx, vz, lx, lz, lvx, lvz = s.unbind(0)
    thrust, w = act[0], act[1]
    dt, g, L, m = c["dt"], c["gravity"], c["tether_length"], c["mass"]
    hx, hz = torch.cos(th + _HALF_PI), torch.sin(th + _HALF_PI)
    tx, tz = lx - x, lz - z
    tn = torch.sqrt(tx * tx + tz * tz)
    inv = _safe_inv(tn)
    ux, uz = tx * inv, tz * inv
    taut = tn >= L

    sc = m * L * (lvx * lvx + lvz * lvz)
    proj = ux * (thrust * hx - sc) + uz * (thrust * hz - sc)
    lax_t = proj * ux * c["inv_mml"]
    laz_t = proj * uz * c["inv_mml"] + g
    lax, laz = torch.where(taut, lax_t, 0.0), torch.where(taut, laz_t, g)
    nlvx, nlvz = lvx + lax * dt, lvz + laz * dt
    nlx = lx + nlvx * dt + 0.5 * lax * dt * dt
    nlz = lz + nlvz * dt + 0.5 * laz * dt * dt

    dzg = laz_t - g
    tmag = c["load_mass"] * torch.sqrt(lax_t * lax_t + dzg * dzg)
    fx = torch.where(taut, tmag * ux * c["inv_m"], 0.0)
    fz = torch.where(taut, tmag * uz * c["inv_m"], 0.0)
    tm = thrust * c["inv_m"]
    ax = tm * hx + fx
    az = tm * hz + g + fz
    nvx, nvz = vx + ax * dt, vz + az * dt
    npx = x + nvx * dt + 0.5 * ax * dt * dt
    npz = z + nvz * dt + 0.5 * az * dt * dt

    dx, dz = nlx - npx, nlz - npz
    dinv = _safe_inv(torch.sqrt(dx * dx + dz * dz))
    ddx, ddz = dx * dinv, dz * dinv
    rad = (nlvx - nvx) * ddx + (nlvz - nvz) * ddz
    nlx = torch.where(taut, npx + ddx * L, nlx)
    nlz = torch.where(taut, npz + ddz * L, nlz)
    nlvx = torch.where(taut, nlvx - rad * ddx, nlvx)
    nlvz = torch.where(taut, nlvz - rad * ddz, nlvz)
    lpn2 = nlx * nlx + nlz * nlz
    lvn2 = nlvx * nlvx + nlvz * nlvz
    done = (lpn2 > c["pos_lim2"]) | (lvn2 > c["vel_lim2"])
    reward = torch.where(done, torch.ones_like(lpn2), -torch.sqrt(npx * npx + npz * npz))
    new = torch.stack([npx, npz, th + w * dt, nvx, nvz, nlx, nlz, nlvx, nlvz])
    return new, reward, done, taut


def slung3d_loop_step(s: torch.Tensor, act: torch.Tensor, c: dict):
    """closed_loop_rollout.cu::Slung3dLoop::step (_slung3d_step_tiles,
    position-first Euler), with :func:`slung2d_loop_step`'s branch-free
    tether."""
    px, py, pz, qw, qx, qy, qz, vx, vy, vz, lx, ly, lz, lvx, lvy, lvz = s.unbind(0)
    thrust, wx, wy, wz = act.unbind(0)
    dt, g, L, m = c["dt"], c["gravity"], c["tether_length"], c["mass"]
    inv_qn, bzx, bzy, bzz = body_z(s)
    tx, ty, tz = lx - px, ly - py, lz - pz
    tn = torch.sqrt(tx * tx + ty * ty + tz * tz)
    inv = _safe_inv(tn)
    ux, uy, uz = tx * inv, ty * inv, tz * inv
    taut = tn >= L

    sc = m * L * (lvx * lvx + lvy * lvy + lvz * lvz)
    proj = ux * (thrust * bzx - sc) + uy * (thrust * bzy - sc) + uz * (thrust * bzz - sc)
    lax_t = proj * ux * c["inv_mml"]
    lay_t = proj * uy * c["inv_mml"]
    laz_t = proj * uz * c["inv_mml"] + g
    lax, lay = torch.where(taut, lax_t, 0.0), torch.where(taut, lay_t, 0.0)
    laz = torch.where(taut, laz_t, g)
    nlx = lx + lvx * dt + 0.5 * lax * dt * dt
    nly = ly + lvy * dt + 0.5 * lay * dt * dt
    nlz = lz + lvz * dt + 0.5 * laz * dt * dt
    nlvx, nlvy, nlvz = lvx + lax * dt, lvy + lay * dt, lvz + laz * dt

    dzg = laz_t - g
    tmag = c["load_mass"] * torch.sqrt(lax_t * lax_t + lay_t * lay_t + dzg * dzg)
    fx = torch.where(taut, tmag * ux * c["inv_m"], 0.0)
    fy = torch.where(taut, tmag * uy * c["inv_m"], 0.0)
    fz = torch.where(taut, tmag * uz * c["inv_m"], 0.0)
    tm = thrust * c["inv_m"]
    ax, ay = tm * bzx + fx, tm * bzy + fy
    az = tm * bzz + g + fz
    npx = px + vx * dt + 0.5 * ax * dt * dt
    npy = py + vy * dt + 0.5 * ay * dt * dt
    npz = pz + vz * dt + 0.5 * az * dt * dt
    nvx, nvy, nvz = vx + ax * dt, vy + ay * dt, vz + az * dt

    dx, dy, dz = nlx - npx, nly - npy, nlz - npz
    dinv = _safe_inv(torch.sqrt(dx * dx + dy * dy + dz * dz))
    ddx, ddy, ddz = dx * dinv, dy * dinv, dz * dinv
    rad = (nlvx - nvx) * ddx + (nlvy - nvy) * ddy + (nlvz - nvz) * ddz

    hdt = c["half_dt"]
    hw, hx, hy, hz = qw * inv_qn, qx * inv_qn, qy * inv_qn, qz * inv_qn
    nqw = qw + hdt * (-hx * wx - hy * wy - hz * wz)
    nqx = qx + hdt * (hw * wx + hy * wz - hz * wy)
    nqy = qy + hdt * (hw * wy - hx * wz + hz * wx)
    nqz = qz + hdt * (hw * wz + hx * wy - hy * wx)

    nlx = torch.where(taut, npx + ddx * L, nlx)
    nly = torch.where(taut, npy + ddy * L, nly)
    nlz = torch.where(taut, npz + ddz * L, nlz)
    nlvx = torch.where(taut, nlvx - rad * ddx, nlvx)
    nlvy = torch.where(taut, nlvy - rad * ddy, nlvy)
    nlvz = torch.where(taut, nlvz - rad * ddz, nlvz)
    lpn2 = nlx * nlx + nly * nly + nlz * nlz
    vn2 = nvx * nvx + nvy * nvy + nvz * nvz
    done = (lpn2 > c["pos_lim2"]) | (vn2 > c["vel_lim2"])
    reward = torch.where(done, torch.ones_like(lpn2), -torch.sqrt(lpn2))
    new = torch.stack([npx, npy, npz, nqw, nqx, nqy, nqz, nvx, nvy, nvz,
                       nlx, nly, nlz, nlvx, nlvy, nlvz])
    return new, reward, done, taut


#: env name -> K8/K9's step in the kernel's arithmetic (the controllers are
#: :data:`KINDS`').
LOOP_STEPS = {"quadrotor2d-v0": quad2d_loop_step,
              "quadrotor2d-slungload-v0": slung2d_loop_step,
              "quadrotor3d-slungload-v0": slung3d_loop_step}


class ClosedLoopKind(NamedTuple):
    """One env kind of the closed-loop kernel: its id in the C entry point
    (the ids of ``csrc/env_kinds.cuh``), its dims, its Params pack and
    field order, and its controller and step in the kernel's arithmetic
    (``control(s, consts) -> act``, ``step(s, act, consts) -> (s, reward,
    done)``)."""

    kind_id: int
    state_dim: int
    action_dim: int
    pack: Callable
    fields: tuple
    control: Callable
    step: Callable


#: env name -> :class:`ClosedLoopKind`.
KINDS = {
    "quadrotor2d-v0": ClosedLoopKind(2, 5, 2, quad2d_params_vec, _Q2_FIELDS, pd2d_control,
                                     quad2d_step),
    "quadrotor2d-slungload-v0": ClosedLoopKind(3, 9, 2, slung2d_params_vec, _S2_FIELDS,
                                               pd2d_control, slung2d_step),
    "quadrotor3d-slungload-v0": ClosedLoopKind(4, 16, 4, slung3d_params_vec, _S3_FIELDS,
                                               slung3d_control, slung3d_step),
}


#: The slung-load kinds: the ones whose tether the counting kernels count.
TAUT_KINDS = ("quadrotor2d-slungload-v0", "quadrotor3d-slungload-v0")


def taut_twin(kind: str, params: torch.Tensor):
    """``taut(s)``: whether the tether of ``(D, B)`` states of a slung-load
    kind is taut, ``|load - quad| >= L`` in the arithmetic of
    :func:`slung2d_step` and :func:`slung3d_step` (what the counting
    instances of K6 and K7 count, at the start of each step)."""
    L = _scalars(KINDS[kind].fields, params)["tether_length"]
    k = 2 + TAUT_KINDS.index(kind)  # position dims

    def taut(s):
        d = [s[s.shape[0] - 2 * k + i] - s[i] for i in range(k)]
        sq = d[0] * d[0] + d[1] * d[1]
        if k == 3:
            sq = sq + d[2] * d[2]
        return torch.sqrt(sq) >= L

    return taut


def env_twin(kind: str, params: torch.Tensor):
    """``(control, step)`` of a kind on ``(D, B)`` states with its params
    vector ``params`` bound (the kernels' derived constants included)."""
    k = KINDS[kind]
    c = _scalars(k.fields, params)
    return (lambda s: k.control(s, c)), (lambda s, act: k.step(s, act, c))


def check_counts(counts, states_t) -> None:
    """A kernel's optional per-env counts: None, or a contiguous int32
    ``(B,)`` tensor on the states' device."""
    if counts is not None and (
            not isinstance(counts, torch.Tensor) or counts.dtype != torch.int32
            or counts.shape != states_t.shape[1:] or not counts.is_contiguous()
            or counts.device != states_t.device):
        raise ValueError(f"counts must be a contiguous int32 ({states_t.shape[1]},) tensor on "
                         f"{states_t.device}")


def _check_args(kind, states_t, seed, horizon, params_vec, counts=None) -> torch.Tensor:
    """Validate what the kernel takes; returns the kind's params vector."""
    if kind not in KINDS:
        raise ValueError(f"kind {kind!r}: the closed-loop kernel takes {sorted(KINDS)}")
    k = KINDS[kind]
    if not isinstance(states_t, torch.Tensor) or states_t.dtype != torch.float32:
        raise TypeError("states_t must be a float32 tensor")
    if states_t.dim() != 2 or states_t.shape[0] != k.state_dim or states_t.shape[1] == 0:
        raise ValueError(f"states_t must be ({k.state_dim}, B) with B > 0, got "
                         f"{tuple(states_t.shape)}")
    if not states_t.is_contiguous():
        raise ValueError("states_t must be contiguous")
    if not 0 <= int(seed) < 2**32:
        raise ValueError(f"seed must fit in uint32, got {seed}")
    if not 0 <= int(horizon) < 2**31:
        raise ValueError(f"horizon must be in [0, 2**31), got {horizon}")
    check_counts(counts, states_t)
    params = k.pack(None) if params_vec is None else params_vec
    if params.shape != (len(k.fields),):
        raise ValueError(f"params_vec must be ({len(k.fields)},), got {tuple(params.shape)}")
    return params.detach().to("cpu", torch.float32)


def closed_loop_rollout_reference(kind: str, states_t: torch.Tensor, seed: int, horizon: int,
                                  params_vec: torch.Tensor | None = None,
                                  autoreset: bool = True, counts: torch.Tensor | None = None):
    """Plain PyTorch twin of K8/K9, on any device: the same float32
    arithmetic in the same order (:data:`LOOP_STEPS`), and the same Philox
    reset draws.  Same arguments and returns as :func:`closed_loop_rollout`."""
    params = _check_args(kind, states_t, seed, horizon, params_vec, counts)
    k = KINDS[kind]
    c = _scalars(k.fields, params)
    step = LOOP_STEPS[kind]
    seed, horizon = int(seed), int(horizon)
    s = states_t.clone()
    reward_sum = torch.zeros_like(s[0])
    count = torch.zeros(s.shape[1], dtype=torch.int32, device=s.device)
    for t in range(horizon):
        s, reward, done, counted = step(s, k.control(s, c), c)
        reward_sum = reward_sum + reward
        count += counted
        if autoreset:
            idx = torch.nonzero(done).squeeze(1)
            if idx.numel():
                s[:, idx] = reset_draws(idx, t, seed, 0, k.state_dim)
    if counts is not None:
        counts.copy_(count)
    return s, reward_sum


def closed_loop_rollout(kind: str, states_t: torch.Tensor, seed: int, horizon: int,
                        params_vec: torch.Tensor | None = None, autoreset: bool = True,
                        counts: torch.Tensor | None = None):
    """K8 (``kind`` quadrotor2d-v0) or K9 (quadrotor2d-slungload-v0,
    quadrotor3d-slungload-v0): ``horizon`` steps of the env's classical
    controller and dynamics with U(-1, 1)^D auto-reset (``autoreset=False``:
    none) in one CUDA launch.

    ``states_t``: ``(D, B)`` float32, contiguous, any ``B > 0``.  ``seed``:
    uint32 key of the Philox reset stream.  ``params_vec``: the kind's pack
    of the env's live Params (default Params when None).  ``counts``: None
    (the main path), or a ``(B,)`` int32 tensor on the states' device that
    receives each env's count over the horizon: its taut env-steps for the
    slung-load kinds, its done env-steps (the resets) for quadrotor2d-v0.
    Returns ``(final (D, B), reward_sum (B,))``, float32.  Launches on the
    current stream and does not synchronise.  A CPU tensor runs the plain
    twin; a CUDA tensor runs the kernel or raises.
    """
    params = _check_args(kind, states_t, seed, horizon, params_vec, counts)
    if states_t.device.type == "cpu":
        return closed_loop_rollout_reference(kind, states_t, seed, horizon, params, autoreset,
                                             counts)
    if states_t.device.type != "cuda":
        raise ValueError(f"unsupported device {states_t.device}")
    from .._build import check, load_library

    lib = load_library()
    batch = states_t.shape[1]
    final = torch.empty_like(states_t)
    reward_sum = torch.empty(batch, dtype=torch.float32, device=states_t.device)
    host_params = (ctypes.c_float * params.shape[0])(*params.tolist())
    with torch.cuda.device(states_t.device):
        rc = lib.closed_loop_rollout_launch(
            KINDS[kind].kind_id, states_t.data_ptr(), final.data_ptr(), reward_sum.data_ptr(),
            None if counts is None else counts.data_ptr(), batch, int(horizon), int(seed),
            int(autoreset), ctypes.addressof(host_params), params.shape[0],
            torch.cuda.current_stream().cuda_stream)
    check(rc, "closed_loop_rollout_launch")
    closed_loop_rollout.launches += 1
    return final, reward_sum


#: Kernel launches so far (a run can show that its path went through K8/K9).
closed_loop_rollout.launches = 0
