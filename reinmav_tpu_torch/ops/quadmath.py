"""Quaternion / rotation math for the PyTorch port of the quadrotor suite.

The counterpart of :mod:`reinmav_tpu.ops.quadmath`: plain functions on
tensors, batched over every leading axis, operating on the trailing
axis.  Dtype polymorphic: float64 for CPU parity with the JAX package
and the NumPy oracle, float32 on the card.  Every function keeps the
tensor's device and dtype.

Semantics (behavioural parity with ethz-asl/reinmav-gym, see the JAX
module for the reference citations):

* Quaternion layout is ``(w, x, y, z)`` everywhere.
* ``quat_to_rotmat`` assumes a *unit* quaternion (pyquaternion's
  ``rotation_matrix`` after its in-place normalisation); callers that
  hold an unnormalised quaternion normalise first and keep the stored
  one unnormalised (PARITY.md Q4).
* ``quat_from_rotmat`` replicates pyquaternion's four-branch
  ``_from_matrix`` on the transposed matrix.
* ``torch.sign(0) == 0``, as ``jnp.sign`` (PARITY.md Q10).
"""

from __future__ import annotations

import torch

_FLOAT64_EPS = float(torch.finfo(torch.float64).eps)


def quat_mul(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Hamilton product ``q1 ⊗ q2``, (w, x, y, z) layout."""
    w1, x1, y1, z1 = q1.unbind(-1)
    w2, x2, y2, z2 = q2.unbind(-1)
    return torch.stack(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ],
        dim=-1,
    )


def quat_conj(q: torch.Tensor) -> torch.Tensor:
    """Quaternion conjugate (w, -x, -y, -z)."""
    return q * q.new_tensor([1.0, -1.0, -1.0, -1.0])


def quat_norm(q: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vector_norm(q, dim=-1)


def quat_normalize(q: torch.Tensor) -> torch.Tensor:
    """Safe normalisation: returns ``q`` unchanged when ``|q| == 0``
    (pyquaternion ``_normalise`` divides only by a positive norm)."""
    n = torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    pos = n > 0.0
    return torch.where(pos, q / torch.where(pos, n, torch.ones_like(n)), q)


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """Rotation matrix of a *unit* quaternion, shape ``(..., 3, 3)``."""
    w, x, y, z = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    row0 = torch.stack([1.0 - 2.0 * (yy + zz), 2.0 * (xy - wz), 2.0 * (xz + wy)], dim=-1)
    row1 = torch.stack([2.0 * (xy + wz), 1.0 - 2.0 * (xx + zz), 2.0 * (yz - wx)], dim=-1)
    row2 = torch.stack([2.0 * (xz - wy), 2.0 * (yz + wx), 1.0 - 2.0 * (xx + yy)], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def quat_to_rotmat_nonunit(q: torch.Tensor) -> torch.Tensor:
    """Non-unit tolerant quaternion → rotation matrix: the reference
    ``quat2mat`` with ``s = 2 / (q·q)`` and the identity for
    ``q·q <= eps``."""
    w, x, y, z = q.unbind(-1)
    nq = w * w + x * x + y * y + z * z
    ok = nq > _FLOAT64_EPS
    s = 2.0 / torch.where(ok, nq, torch.ones_like(nq))
    X, Y, Z = x * s, y * s, z * s
    wX, wY, wZ = w * X, w * Y, w * Z
    xX, xY, xZ = x * X, x * Y, x * Z
    yY, yZ, zZ = y * Y, y * Z, z * Z
    row0 = torch.stack([1.0 - (yY + zZ), xY - wZ, xZ + wY], dim=-1)
    row1 = torch.stack([xY + wZ, 1.0 - (xX + zZ), yZ - wX], dim=-1)
    row2 = torch.stack([xZ - wY, yZ + wX, 1.0 - (xX + yY)], dim=-1)
    mat = torch.stack([row0, row1, row2], dim=-2)
    eye = torch.eye(3, dtype=q.dtype, device=q.device)
    return torch.where(ok[..., None, None], mat, eye)


def quat_derivative(q: torch.Tensor, omega: torch.Tensor) -> torch.Tensor:
    """``q̇ = ½ q ⊗ (0, ω)`` for body rates ``ω``.  The reference calls
    this on the *normalised* quaternion: callers normalise first."""
    omega_q = torch.cat([torch.zeros_like(omega[..., :1]), omega], dim=-1)
    return 0.5 * quat_mul(q, omega_q)


def quat_from_rotmat(m: torch.Tensor) -> torch.Tensor:
    """Rotation matrix → unit quaternion with pyquaternion's branch
    choice (hence sign), all four branches computed and selected."""
    mt = m.transpose(-1, -2)

    def at(i, j):
        return mt[..., i, j]

    # Branch A: m[2,2] < 0 and m[0,0] > m[1,1]
    tA = 1.0 + at(0, 0) - at(1, 1) - at(2, 2)
    qA = torch.stack([at(1, 2) - at(2, 1), tA, at(0, 1) + at(1, 0), at(2, 0) + at(0, 2)], dim=-1)
    # Branch B: m[2,2] < 0 and m[0,0] <= m[1,1]
    tB = 1.0 - at(0, 0) + at(1, 1) - at(2, 2)
    qB = torch.stack([at(2, 0) - at(0, 2), at(0, 1) + at(1, 0), tB, at(1, 2) + at(2, 1)], dim=-1)
    # Branch C: m[2,2] >= 0 and m[0,0] < -m[1,1]
    tC = 1.0 - at(0, 0) - at(1, 1) + at(2, 2)
    qC = torch.stack([at(0, 1) - at(1, 0), at(2, 0) + at(0, 2), at(1, 2) + at(2, 1), tC], dim=-1)
    # Branch D: m[2,2] >= 0 and m[0,0] >= -m[1,1]
    tD = 1.0 + at(0, 0) + at(1, 1) + at(2, 2)
    qD = torch.stack([tD, at(1, 2) - at(2, 1), at(2, 0) - at(0, 2), at(0, 1) - at(1, 0)], dim=-1)

    neg_zz = at(2, 2) < 0.0
    first = at(0, 0) > at(1, 1)
    second = at(0, 0) < -at(1, 1)
    q_neg = torch.where(first[..., None], qA, qB)
    t_neg = torch.where(first, tA, tB)
    q_pos = torch.where(second[..., None], qC, qD)
    t_pos = torch.where(second, tC, tD)
    q = torch.where(neg_zz[..., None], q_neg, q_pos)
    t = torch.where(neg_zz, t_neg, t_pos)
    return q * (0.5 / torch.sqrt(t))[..., None]


def acc2quat(desired_acc: torch.Tensor) -> torch.Tensor:
    """Desired acceleration → attitude quaternion (geometric controller):
    ``zb = â``, ``xb = yc × zb`` normalised with ``yc = (0, 1, 0)``,
    ``yb = zb × xb``, matrix columns ``[xb yb zb]``, then
    :func:`quat_from_rotmat`."""
    zb = desired_acc / torch.linalg.vector_norm(desired_acc, dim=-1, keepdim=True)
    yc = desired_acc.new_tensor([0.0, 1.0, 0.0]).expand_as(zb)
    xb = torch.linalg.cross(yc, zb, dim=-1)
    xb = xb / torch.linalg.vector_norm(xb, dim=-1, keepdim=True)
    yb = torch.linalg.cross(zb, xb, dim=-1)
    zb = zb / torch.linalg.vector_norm(zb, dim=-1, keepdim=True)
    rotmat = torch.stack([xb, yb, zb], dim=-1)  # columns are xb, yb, zb
    return quat_from_rotmat(rotmat)


def rot_to_rpy_zxy(r: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """ZXY Euler extraction (phi, theta, psi), the reference ``RotToRPY``."""
    phi = torch.asin(r[..., 1, 2])
    cphi = torch.cos(phi)
    psi = torch.atan2(-r[..., 1, 0] / cphi, r[..., 1, 1] / cphi)
    theta = torch.atan2(-r[..., 0, 2] / cphi, r[..., 2, 2] / cphi)
    return phi, theta, psi


def quat_to_rpy(q: torch.Tensor) -> torch.Tensor:
    """Roll/pitch/yaw of the cascaded RPY PID controller, shape ``(..., 3)``."""
    w, x, y, z = q.unbind(-1)
    roll = torch.atan2(2.0 * (w * x + y * z), 1.0 - 2.0 * (x * x + y * y))
    pitch = torch.asin(2.0 * (w * y - z * x))
    yaw = torch.atan2(2.0 * (w * z + x * y), 1.0 - 2.0 * (y * y + z * z))
    return torch.stack([roll, pitch, yaw], dim=-1)
