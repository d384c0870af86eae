"""Kernel K1: the fused quadrotor3d closed-loop rollout, and its plain twin.

The counterpart of :mod:`reinmav_tpu.ops.pallas_rollout` (the quadrotor3d
part).  :func:`quad3d_rollout_autoreset` runs the whole horizon of
controller + dynamics + auto-reset in one CUDA kernel written by hand
for Hopper on a ``(10, B)`` float32 state: the ``Quad3dLoop`` instance of
the closed-loop template of ``csrc/closed_loop_rollout.cu`` (K8/K9's), its
own step, the auto-reset fixed at compile time.
:func:`quad3d_rollout_reference` is its plain PyTorch twin: the same
arithmetic in the same order, and the same Philox4x32-10 reset draws
written with int64 tensor arithmetic.  So the two agree on the card to
float32 rounding, auto-reset included, and the CPU tests run the twin.

The wrapper takes the twin only for a tensor that lies on the CPU; on a
CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

#: envs/quadrotor3d.Params field order, the order the kernel reads them in.
_Q3_FIELDS = ("mass", "dt", "gravity", "ref_x", "ref_y", "ref_z",
              "pos_limit", "vel_limit", "kp", "kv", "tau")
_QUAD3D_KIND = 0  # its kind id in csrc/env_kinds.cuh

# Philox4x32-10 constants (Random123).
_MASK = 0xFFFFFFFF
_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85


def quad3d_params_vec(p=None) -> torch.Tensor:
    """quadrotor3d Params (default when None) -> (11,) float32 CPU tensor
    in kernel order; a field-order mismatch raises rather than
    mis-wiring a constant."""
    from ..envs.quadrotor3d import Params

    p = p or Params()
    if type(p)._fields != _Q3_FIELDS:
        raise ValueError(f"params fields {type(p)._fields} != kernel table {_Q3_FIELDS}")
    return torch.tensor([float(v) for v in p], dtype=torch.float32)


# --- Philox4x32-10 ------------------------------------------------------------


def philox4x32_10_reference(counter: torch.Tensor, key: torch.Tensor) -> torch.Tensor:
    """Philox4x32-10 on int64 tensors holding uint32 words: ``counter``
    ``(..., 4)`` and ``key`` ``(..., 2)``, broadcast; returns ``(..., 4)``.

    A 32×32-bit product does not fit a signed int64: it wraps, and the
    masks with ``0xFFFFFFFF`` recover its hi and lo words exactly.
    """
    c0, c1, c2, c3 = counter.to(torch.int64).unbind(-1)
    k0, k1 = key.to(torch.int64).unbind(-1)
    for _ in range(10):
        p0 = c0 * _M0
        p1 = c2 * _M1
        hi0, lo0 = (p0 >> 32) & _MASK, p0 & _MASK
        hi1, lo1 = (p1 >> 32) & _MASK, p1 & _MASK
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + _W0) & _MASK
        k1 = (k1 + _W1) & _MASK
    return torch.stack(torch.broadcast_tensors(c0, c1, c2, c3), dim=-1)


def _as_u32_in_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 holding uint32 values -> int32 with the same bits."""
    x = x.to(torch.int64) & _MASK
    return torch.where(x >= 2**31, x - 2**32, x).to(torch.int32)


def philox4x32_10(counter: torch.Tensor, key: torch.Tensor) -> torch.Tensor:
    """Philox4x32-10 through the kernel library on a CUDA tensor (the
    generator the rollout kernel draws from), or the plain twin on a CPU
    tensor.  ``counter`` ``(N, 4)`` and ``key`` ``(N, 2)``, int64 holding
    uint32 words; returns ``(N, 4)`` int64."""
    if counter.dim() != 2 or counter.shape[1] != 4 or key.shape != (counter.shape[0], 2):
        raise ValueError(f"counter (N, 4) and key (N, 2) expected, got "
                         f"{tuple(counter.shape)} and {tuple(key.shape)}")
    if counter.device != key.device:
        raise ValueError("counter and key must be on one device")
    if counter.device.type == "cpu":
        return philox4x32_10_reference(counter, key)
    if counter.device.type != "cuda":
        raise ValueError(f"unsupported device {counter.device}")
    from .._build import check, load_library

    lib = load_library()
    ctr = _as_u32_in_i32(counter).contiguous()
    k = _as_u32_in_i32(key).contiguous()
    out = torch.empty_like(ctr)
    with torch.cuda.device(counter.device):
        rc = lib.philox4x32_10_launch(ctr.data_ptr(), k.data_ptr(), out.data_ptr(),
                                      ctr.shape[0], torch.cuda.current_stream().cuda_stream)
    check(rc, "philox4x32_10_launch")
    return out.to(torch.int64) & _MASK


def philox_words(env_idx: torch.Tensor, step: int, seed: int, draws: int,
                 stream: int) -> torch.Tensor:
    """The kernels' Philox blocks for envs ``env_idx`` at ``step``: counter
    (env, step, draw, stream) for draw in [0, draws), key (seed, 0).
    Returns ``(4 * draws, n)`` int64 words, word ``k % 4`` of draw
    ``k // 4`` in row ``k``."""
    dev = env_idx.device
    n = env_idx.shape[0]
    counter = torch.stack([
        env_idx.to(torch.int64).expand(draws, n),
        torch.full((draws, n), step, dtype=torch.int64, device=dev),
        torch.arange(draws, dtype=torch.int64, device=dev)[:, None].expand(draws, n),
        torch.full((draws, n), stream, dtype=torch.int64, device=dev),
    ], dim=-1)
    key = torch.tensor([seed, 0], dtype=torch.int64, device=dev)
    return philox4x32_10_reference(counter, key).permute(0, 2, 1).reshape(4 * draws, n)


def mantissa_fill(bits: torch.Tensor) -> torch.Tensor:
    """Philox words -> float32 in [1, 2) by mantissa fill."""
    return ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)


def reset_draws(env_idx: torch.Tensor, step: int, seed: int, stream: int = 0,
                dim: int = 10) -> torch.Tensor:
    """The kernels' U(-1, 1)^dim reset of envs ``env_idx`` at ``step``:
    ceil(dim / 4) Philox blocks with counter (env, step, draw, stream) and
    key (seed, 0); component ``k`` is word ``k % 4`` of draw ``k // 4``.
    K1, K8 and K9 draw on stream 0, K2/K6 on stream 2, K7 on stream 5.
    Returns ``(dim, n)`` float32."""
    f12 = mantissa_fill(philox_words(env_idx, step, seed, -(-dim // 4), stream)[:dim])
    # Mantissa fill to [1, 2), then affine (pallas_rollout.py:206-211).
    return 2.0 * (f12 - 1.0) - 1.0


def body_z(s: torch.Tensor):
    """``(inv_qn, bzx, bzy, bzz)``: the inverse quaternion norm and the body
    z axis of the normalised quaternion of ``(10, B)`` states, as the
    kernels' shared ``body_z`` (csrc/quad3d_common.cuh)."""
    qw, qx, qy, qz = s[3], s[4], s[5], s[6]
    qn2 = qw * qw + qx * qx + qy * qy + qz * qz
    inv_qn = torch.rsqrt(qn2)
    inv_qn2 = inv_qn * inv_qn
    return (inv_qn, 2.0 * (qx * qz + qw * qy) * inv_qn2, 2.0 * (qy * qz - qw * qx) * inv_qn2,
            1.0 - 2.0 * (qx * qx + qy * qy) * inv_qn2)


def geometric_control(s: torch.Tensor, kp: float, kv: float, ref_x: float, ref_y: float,
                      ref_z: float, gz: float, two_over_tau: float):
    """The geometric controller on ``(10 or more, B)`` states ``[p q v
    ...]``, in the order of the kernels' shared ``geometric_control``
    (csrc/quad3d_common.cuh).  Returns ``(thrust, wx, wy, wz, bz)``: the
    mass-blind thrust, the body rates, and :func:`body_z` for the
    dynamics."""
    px, py, pz, qw, qx, qy, qz, vx, vy, vz = s[:10].unbind(0)
    ax = kp * (px - ref_x) + kv * vx
    ay = kp * (py - ref_y) + kv * vy
    az = kp * (pz - ref_z) + kv * vz - gz
    an = torch.rsqrt(ax * ax + ay * ay + az * az)
    zbx, zby, zbz = ax * an, ay * an, az * an
    xn = torch.rsqrt(zbz * zbz + zbx * zbx)
    xbx, xbz = zbz * xn, -zbx * xn
    ybx = zby * xbz
    yby = zbz * xbx - zbx * xbz
    ybz = -zby * xbx

    m00, m02 = xbx, xbz
    m10, m11, m12 = ybx, yby, ybz
    m20, m21, m22 = zbx, zby, zbz
    tA = 1.0 + m00 - m11 - m22
    qA = (m12 - m21, tA, m10, m20 + m02)
    tB = 1.0 - m00 + m11 - m22
    qB = (m20 - m02, m10, tB, m12 + m21)
    tC = 1.0 - m00 - m11 + m22
    qC = (-m10, m20 + m02, m12 + m21, tC)
    tD = 1.0 + m00 + m11 + m22
    qD = (tD, m12 - m21, m20 - m02, -m10)
    neg, first, second = m22 < 0.0, m00 > m11, m00 < -m11

    def select(a, b, c, d):
        return torch.where(neg, torch.where(first, a, b), torch.where(second, c, d))

    scale = 0.5 * torch.rsqrt(select(tA, tB, tC, tD))
    dw, dx, dy, dz = (select(*qs) * scale for qs in zip(qA, qB, qC, qD))

    ew = qw * dw + qx * dx + qy * dy + qz * dz
    ex = qw * dx - qx * dw - qy * dz + qz * dy
    ey = qw * dy + qx * dz - qy * dw - qz * dx
    ez = qw * dz - qx * dy + qy * dx - qz * dw
    k = two_over_tau * torch.sign(ew)

    # Body z of the normalised quaternion, shared by thrust and dynamics.
    bz = body_z(s)
    return ax * bz[1] + ay * bz[2] + az * bz[3], k * ex, k * ey, k * ez, bz


def quad3d_dynamics(s: torch.Tensor, bz, tq, wx, wy, wz, dt: float, gz: float, half_dt: float,
                    pos_lim2: float, vel_lim2: float):
    """One quadrotor3d dynamics step on ``(10, B)`` states with body z
    ``bz`` (:func:`body_z`), thrust / mass ``tq`` and body rates, in the
    order of the kernels' shared ``quad3d_dynamics``
    (csrc/quad3d_common.cuh).  Returns ``(new states, reward, done)``."""
    px, py, pz, qw, qx, qy, qz, vx, vy, vz = s.unbind(0)
    inv_qn, bzx, bzy, bzz = bz
    accx = tq * bzx
    accy = tq * bzy
    accz = tq * bzz + gz
    npx = px + vx * dt + 0.5 * accx * dt * dt
    npy = py + vy * dt + 0.5 * accy * dt * dt
    npz = pz + vz * dt + 0.5 * accz * dt * dt
    nvx, nvy, nvz = vx + accx * dt, vy + accy * dt, vz + accz * dt
    hw, hx, hy, hz = qw * inv_qn, qx * inv_qn, qy * inv_qn, qz * inv_qn
    nqw = qw + half_dt * (-hx * wx - hy * wy - hz * wz)
    nqx = qx + half_dt * (hw * wx + hy * wz - hz * wy)
    nqy = qy + half_dt * (hw * wy - hx * wz + hz * wx)
    nqz = qz + half_dt * (hw * wz + hx * wy - hy * wx)
    pn2 = npx * npx + npy * npy + npz * npz
    vn2 = nvx * nvx + nvy * nvy + nvz * nvz
    done = (pn2 > pos_lim2) | (vn2 > vel_lim2)
    reward = torch.where(done, torch.ones_like(pn2), -torch.sqrt(pn2))
    new = torch.stack([npx, npy, npz, nqw, nqx, nqy, nqz, nvx, nvy, nvz])
    return new, reward, done


# --- K1 -------------------------------------------------------------------------


def _check_args(states_t, seed, horizon, params_vec) -> torch.Tensor:
    """Validate what the kernel takes; returns the (11,) params vector."""
    if not isinstance(states_t, torch.Tensor) or states_t.dtype != torch.float32:
        raise TypeError("states_t must be a float32 tensor")
    if states_t.dim() != 2 or states_t.shape[0] != 10 or states_t.shape[1] == 0:
        raise ValueError(f"states_t must be (10, B) with B > 0, got {tuple(states_t.shape)}")
    if not states_t.is_contiguous():
        raise ValueError("states_t must be contiguous")
    if not 0 <= int(seed) < 2**32:
        raise ValueError(f"seed must fit in uint32, got {seed}")
    if not 0 <= int(horizon) < 2**31:
        raise ValueError(f"horizon must be in [0, 2**31), got {horizon}")
    params = quad3d_params_vec() if params_vec is None else params_vec
    if params.shape != (len(_Q3_FIELDS),):
        raise ValueError(f"params_vec must be ({len(_Q3_FIELDS)},), got {tuple(params.shape)}")
    return params.detach().to("cpu", torch.float32)


def quad3d_rollout_reference(states_t: torch.Tensor, seed: int, horizon: int,
                             params_vec: torch.Tensor | None = None, autoreset: bool = True):
    """Plain PyTorch twin of the K1 kernel, on any device: the same
    float32 arithmetic in the same order, and the same Philox reset
    draws.  Returns ``(final (10, B), reward_sum (B,))``."""
    params = _check_args(states_t, seed, horizon, params_vec)
    p = dict(zip(_Q3_FIELDS, params.numpy()))  # float32 scalars
    # Derived constants in float32, as the kernel's prologue computes them.
    two_over_tau = float(np.float32(2.0) / p["tau"])
    inv_m = float(np.float32(1.0) / p["mass"])
    half_dt = float(np.float32(0.5) * p["dt"])
    pos_lim2 = float(p["pos_limit"] * p["pos_limit"])
    vel_lim2 = float(p["vel_limit"] * p["vel_limit"])
    kp, kv, dt, gz = (float(p[n]) for n in ("kp", "kv", "dt", "gravity"))
    ref_x, ref_y, ref_z = (float(p[n]) for n in ("ref_x", "ref_y", "ref_z"))
    seed, horizon = int(seed), int(horizon)

    s = states_t.clone()
    reward_sum = torch.zeros_like(s[0])
    for t in range(horizon):
        thrust, wx, wy, wz, bz = geometric_control(s, kp, kv, ref_x, ref_y, ref_z, gz,
                                                   two_over_tau)
        s, reward, done = quad3d_dynamics(s, bz, thrust * inv_m, wx, wy, wz, dt, gz, half_dt,
                                          pos_lim2, vel_lim2)
        reward_sum = reward_sum + reward

        if autoreset:
            idx = torch.nonzero(done).squeeze(1)
            if idx.numel():
                s[:, idx] = reset_draws(idx, t, seed)
    return s, reward_sum


def quad3d_rollout_autoreset(states_t: torch.Tensor, seed: int, horizon: int,
                             params_vec: torch.Tensor | None = None, autoreset: bool = True):
    """K1: ``horizon`` closed-loop quadrotor3d steps with U(-1,1)^10
    auto-reset (``autoreset=False``: none) in one CUDA launch.

    ``states_t``: ``(10, B)`` float32, contiguous, any ``B > 0``.
    ``seed``: uint32 key of the Philox reset stream.  ``params_vec``:
    :func:`quad3d_params_vec` output (default Params when None).
    Returns ``(final (10, B), reward_sum (B,))``, float32.  Launches on
    the current stream and does not synchronise.  A CPU tensor runs the
    plain twin; a CUDA tensor runs the kernel or raises.
    """
    params = _check_args(states_t, seed, horizon, params_vec)
    if states_t.device.type == "cpu":
        return quad3d_rollout_reference(states_t, seed, horizon, params, autoreset)
    if states_t.device.type != "cuda":
        raise ValueError(f"unsupported device {states_t.device}")
    from .._build import check, load_library

    lib = load_library()
    batch = states_t.shape[1]
    final = torch.empty_like(states_t)
    reward_sum = torch.empty(batch, dtype=torch.float32, device=states_t.device)
    host_params = (ctypes.c_float * len(_Q3_FIELDS))(*params.tolist())
    with torch.cuda.device(states_t.device):
        rc = lib.closed_loop_rollout_launch(
            _QUAD3D_KIND, states_t.data_ptr(), final.data_ptr(), reward_sum.data_ptr(), None,
            batch, int(horizon), int(seed), int(autoreset), ctypes.addressof(host_params),
            len(_Q3_FIELDS), torch.cuda.current_stream().cuda_stream)
    check(rc, "closed_loop_rollout_launch (K1)")
    quad3d_rollout_autoreset.launches += 1
    return final, reward_sum


#: Kernel launches so far (a run can show that its path went through K1).
quad3d_rollout_autoreset.launches = 0
