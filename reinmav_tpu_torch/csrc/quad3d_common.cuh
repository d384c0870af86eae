// Device code shared by the quadrotor3d kernels: K1 (closed_loop_rollout.cu,
// the closed loop under the geometric controller: Philox, the reset and
// body_z from here, its own controller and dynamics), K2 (ppo_rollout.cu,
// the closed loop under the PPO policy) and, through env_kinds.cuh, K7 and
// the quadrotor3d-slungload closed loop (K9).  Philox4x32-10, the U(-1, 1) and
// U[0, 1) draws from its words and the U(-1, 1)^D reset, the geometric
// controller, and the quadrotor3d dynamics step of
// reinmav_tpu/envs/quadrotor3d.py:step.  The plain PyTorch twins write the
// same arithmetic in reinmav_tpu_torch/ops/rollout.py and ops/ppo_rollout.py.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace reinmav {

// Field order of reinmav_tpu_torch/envs/quadrotor3d.py::Params (_Q3_FIELDS).
struct Quad3dParams {
  float mass, dt, gravity, ref_x, ref_y, ref_z, pos_limit, vel_limit, kp, kv, tau;
};

constexpr uint32_t kPhiloxM0 = 0xD2511F53u;
constexpr uint32_t kPhiloxM1 = 0xCD9E8D57u;
constexpr uint32_t kPhiloxW0 = 0x9E3779B9u;
constexpr uint32_t kPhiloxW1 = 0xBB67AE85u;

// Philox4x32-10 (Salmon et al., SC'11; the Random123 reference): ten rounds,
// the key bumped by the Weyl constants after each.
__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t hi0 = __umulhi(kPhiloxM0, c.x);
    const uint32_t lo0 = kPhiloxM0 * c.x;
    const uint32_t hi1 = __umulhi(kPhiloxM1, c.z);
    const uint32_t lo1 = kPhiloxM1 * c.z;
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
    k0 += kPhiloxW0;
    k1 += kPhiloxW1;
  }
  return c;
}

// U[0, 1) by mantissa fill to [1, 2), minus one (pallas_ppo_rollout.py:83-87).
__device__ __forceinline__ float uniform01(uint32_t bits) {
  return __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
}

// U(-1, 1) by mantissa fill to [1, 2), then affine (pallas_rollout.py:206-211).
__device__ __forceinline__ float uniform_pm1(uint32_t bits) {
  const float f12 = __uint_as_float((bits >> 9) | 0x3F800000u);
  return 2.0f * (f12 - 1.0f) - 1.0f;
}

// The U(-1, 1)^D reset of env `env` at step `step`: ceil(D / 4) Philox blocks
// with counter (env, step, draw, stream) and key (seed, 0); component k is
// word k % 4 of draw k / 4 (the twin: ops/rollout.py::reset_draws).
template <int D>
__device__ __forceinline__ void reset_uniform(float (&s)[D], uint32_t env, uint32_t step,
                                              uint32_t seed, uint32_t stream) {
#pragma unroll
  for (int k = 0; k < (D + 3) / 4; ++k) {
    const uint4 b = philox4x32_10(make_uint4(env, step, static_cast<uint32_t>(k), stream), seed,
                                  0u);
    const uint32_t w[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (4 * k + j < D) s[4 * k + j] = uniform_pm1(w[j]);
    }
  }
}

// Body z axis of the NORMALISED quaternion of s = [p(3) q(4) v(3) ...], and
// the inverse quaternion norm that the quaternion update reuses.
struct BodyZ {
  float inv_qn, x, y, z;
};

template <int N>
__device__ __forceinline__ BodyZ body_z(const float (&s)[N]) {
  const float qw = s[3], qx = s[4], qy = s[5], qz = s[6];
  const float qn2 = qw * qw + qx * qx + qy * qy + qz * qz;
  const float inv_qn = rsqrtf(qn2);
  const float inv_qn2 = inv_qn * inv_qn;
  return {inv_qn, 2.0f * (qx * qz + qw * qy) * inv_qn2, 2.0f * (qy * qz - qw * qx) * inv_qn2,
          1.0f - 2.0f * (qx * qx + qy * qy) * inv_qn2};
}

// The geometric controller (reinmav_tpu/ops/pallas_rollout.py::
// tilt_controller_tiles :241) on s = [p(3) q(4) v(3) ...]: the PD desired
// acceleration, its Gram-Schmidt frame, pyquaternion's _from_matrix branch
// select, and the rate command from the error against the RAW quaternion.
// The thrust is mass-blind, projected on the body z of the normalised
// quaternion, which is returned for the dynamics to reuse.
struct GeometricCmd {
  float thrust, wx, wy, wz;
  BodyZ bz;
};

template <int N>
__device__ __forceinline__ GeometricCmd geometric_control(const float (&s)[N], float kp, float kv,
                                                          float ref_x, float ref_y, float ref_z,
                                                          float gz, float two_over_tau) {
  const float px = s[0], py = s[1], pz = s[2];
  const float qw = s[3], qx = s[4], qy = s[5], qz = s[6];
  const float vx = s[7], vy = s[8], vz = s[9];

  const float ax = kp * (px - ref_x) + kv * vx;
  const float ay = kp * (py - ref_y) + kv * vy;
  const float az = kp * (pz - ref_z) + kv * vz - gz;

  const float an = rsqrtf(ax * ax + ay * ay + az * az);
  const float zbx = ax * an, zby = ay * an, zbz = az * an;
  // xb = yc x zb with yc = (0, 1, 0): (zbz, 0, -zbx), normalised.
  const float xn = rsqrtf(zbz * zbz + zbx * zbx);
  const float xbx = zbz * xn, xbz = -zbx * xn;
  // yb = zb x xb
  const float ybx = zby * xbz;
  const float yby = zbz * xbx - zbx * xbz;
  const float ybz = -zby * xbx;

  // pyquaternion _from_matrix on the transposed [xb yb zb]: rows xb, yb, zb
  // (m01 = xb_y = 0).
  const float m00 = xbx, m02 = xbz;
  const float m10 = ybx, m11 = yby, m12 = ybz;
  const float m20 = zbx, m21 = zby, m22 = zbz;
  float t, dw, dx, dy, dz;
  if (m22 < 0.0f) {
    if (m00 > m11) {  // branch A
      t = 1.0f + m00 - m11 - m22;
      dw = m12 - m21; dx = t; dy = m10; dz = m20 + m02;
    } else {  // branch B
      t = 1.0f - m00 + m11 - m22;
      dw = m20 - m02; dx = m10; dy = t; dz = m12 + m21;
    }
  } else {
    if (m00 < -m11) {  // branch C
      t = 1.0f - m00 - m11 + m22;
      dw = -m10; dx = m20 + m02; dy = m12 + m21; dz = t;
    } else {  // branch D
      t = 1.0f + m00 + m11 + m22;
      dw = t; dx = m12 - m21; dy = m20 - m02; dz = -m10;
    }
  }
  const float scale = 0.5f * rsqrtf(t);
  dw *= scale; dx *= scale; dy *= scale; dz *= scale;

  // qe = conj(q_raw) (x) q_des; rate command from the RAW quaternion.
  const float ew = qw * dw + qx * dx + qy * dy + qz * dz;
  const float ex = qw * dx - qx * dw - qy * dz + qz * dy;
  const float ey = qw * dy + qx * dz - qy * dw - qz * dx;
  const float ez = qw * dz - qx * dy + qy * dx - qz * dw;
  const float sgn = ew > 0.0f ? 1.0f : (ew < 0.0f ? -1.0f : 0.0f);  // sign(0) = 0 (Q10)
  const float k = two_over_tau * sgn;

  // Body z of the NORMALISED quaternion, shared by thrust and dynamics.
  const BodyZ bz = body_z(s);
  return {ax * bz.x + ay * bz.y + az * bz.z, k * ex, k * ey, k * ez, bz};
}

// One dynamics step of quadrotor3d with thrust / mass `tq` along body z and
// body rates (wx, wy, wz): position-first Euler with the old velocity, the
// derivative of the normalised quaternion added to the raw stored one.
// Updates s in place, sets done, and returns the step's reward.
__device__ __forceinline__ float quad3d_dynamics(float (&s)[10], const BodyZ& bz, float tq,
                                                 float wx, float wy, float wz, float dt,
                                                 float gz, float half_dt, float pos_lim2,
                                                 float vel_lim2, bool& done) {
  const float px = s[0], py = s[1], pz = s[2];
  const float qw = s[3], qx = s[4], qy = s[5], qz = s[6];
  const float vx = s[7], vy = s[8], vz = s[9];

  const float accx = tq * bz.x;
  const float accy = tq * bz.y;
  const float accz = tq * bz.z + gz;

  const float npx = px + vx * dt + 0.5f * accx * dt * dt;
  const float npy = py + vy * dt + 0.5f * accy * dt * dt;
  const float npz = pz + vz * dt + 0.5f * accz * dt * dt;
  const float nvx = vx + accx * dt, nvy = vy + accy * dt, nvz = vz + accz * dt;

  const float hw = qw * bz.inv_qn, hx = qx * bz.inv_qn, hy = qy * bz.inv_qn, hz = qz * bz.inv_qn;
  s[3] = qw + half_dt * (-hx * wx - hy * wy - hz * wz);
  s[4] = qx + half_dt * (hw * wx + hy * wz - hz * wy);
  s[5] = qy + half_dt * (hw * wy - hx * wz + hz * wx);
  s[6] = qz + half_dt * (hw * wz + hx * wy - hy * wx);
  s[0] = npx; s[1] = npy; s[2] = npz;
  s[7] = nvx; s[8] = nvy; s[9] = nvz;

  const float pn2 = npx * npx + npy * npy + npz * npz;
  const float vn2 = nvx * nvx + nvy * nvy + nvz * nvz;
  done = (pn2 > pos_lim2) || (vn2 > vel_lim2);
  return done ? 1.0f : -sqrtf(pn2);
}

}  // namespace reinmav
