// Device code of the hover task (MujocoQuadForce-v1), shared by K5
// (hover_rollout.cu, the constant-action throughput rollout) and K6-hover
// (ppo_rollout.cu, the fused PPO rollout): the params, the motor wrench of
// a 4-vector action, one rigid-body substep without contact, the hovering
// reward and done, and the deterministic reset.
//
// The arithmetic is the TPU kernels' component form,
// reinmav_tpu/ops/pallas_tpuquad.py::_rigid_substep (:348-446, contact=False,
// no servo) and _hover_step_tiles (:449-486), which differs from the env's
// matrix form (envs/tpuquad.py:_physics_step) only in rounding.  The plain
// PyTorch twins write the same arithmetic in
// reinmav_tpu_torch/ops/hover_rollout.py (hover_substep, hover_reward_done).
// The derived drag constants are formed with the _rn intrinsics, so that
// kernel and twin start from the same floats; the step itself lets nvcc
// contract products into FMAs, and the comparisons count the envs that
// disagree.  sinf / cosf / sqrtf are the accurate library functions (no
// -use_fast_math), and the ang > 1e-9 guard of the exp-map is kept.
//
// contact_rollout.cu (K11) keeps its own copy of hover_substep's arithmetic,
// cut into pieces around the contact solve (rigid_rotation,
// rigid_free_wrench, rigid_gyro, rigid_integrate): an edit to one must be
// made to the other.  tests/test_torch_contact_rollout.py::
// test_rigid_substep_is_the_hover_substep holds the two twins bit for bit,
// tests/test_torch_cuda_reinmav_contact.py::test_k11_in_flight_is_k5 the two
// kernels at the float32 tolerance.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace reinmav {

// Field order of reinmav_tpu_torch/ops/hover_rollout.py::hover_params_vec
// (the JAX package's pallas_tpuquad.hover_params_vec, :105-116).
struct HoverParams {
  float mass, ix, iy, iz, cz, g, dt, init_z, arm, yaw_gear, ctrl_high, mu, density, viscosity,
      dx, dy, dz;
};
constexpr int kHoverParams = 17;

__host__ __device__ inline HoverParams hover_params_from(const float* h) {
  return HoverParams{h[0],  h[1],  h[2],  h[3],  h[4],  h[5],  h[6],  h[7], h[8],
                     h[9],  h[10], h[11], h[12], h[13], h[14], h[15], h[16]};
}

// The fluid-drag constants derived from the params, in the twin's order:
// viscous (3 pi nu d) and (pi nu d^3) with d the mean box width, the
// per-axis quadratic force (0.5 rho Dj Dk) and torque (rho Di (Dj^4 + Dk^4)
// / 64) coefficients.
struct HoverDrag {
  float kv, kt, fx, fy, fz, tx, ty, tz;
};

__device__ __forceinline__ HoverDrag hover_drag(const HoverParams& c) {
  const float diam = __fdiv_rn(__fadd_rn(__fadd_rn(c.dx, c.dy), c.dz), 3.0f);
  const float diam3 = __fmul_rn(diam, __fmul_rn(diam, diam));
  const float dx2 = __fmul_rn(c.dx, c.dx), dy2 = __fmul_rn(c.dy, c.dy), dz2 = __fmul_rn(c.dz, c.dz);
  const float dx4 = __fmul_rn(dx2, dx2), dy4 = __fmul_rn(dy2, dy2), dz4 = __fmul_rn(dz2, dz2);
  const float half_rho = __fmul_rn(0.5f, c.density);
  HoverDrag k;
  k.kv = __fmul_rn(__fmul_rn(9.42477796076938f, c.viscosity), diam);  // 3 pi
  k.kt = __fmul_rn(__fmul_rn(3.14159265358979f, c.viscosity), diam3);
  k.fx = __fmul_rn(__fmul_rn(half_rho, c.dy), c.dz);
  k.fy = __fmul_rn(__fmul_rn(half_rho, c.dz), c.dx);
  k.fz = __fmul_rn(__fmul_rn(half_rho, c.dx), c.dy);
  k.tx = __fdiv_rn(__fmul_rn(__fmul_rn(c.density, c.dx), __fadd_rn(dy4, dz4)), 64.0f);
  k.ty = __fdiv_rn(__fmul_rn(__fmul_rn(c.density, c.dy), __fadd_rn(dz4, dx4)), 64.0f);
  k.tz = __fdiv_rn(__fmul_rn(__fmul_rn(c.density, c.dz), __fadd_rn(dx4, dy4)), 64.0f);
  return k;
}

// The motor wrench of the raw action a: the clipped controls' total thrust
// and the body torques (motor y = (+,-,-,+), motor x = (+,+,-,-), yaw sign
// (-,+,-,+)).
struct HoverWrench {
  float total, mx, my, mz;
};

__device__ __forceinline__ HoverWrench hover_wrench(const float (&a)[4], const HoverParams& c) {
  float u[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) u[i] = fminf(fmaxf(a[i], 0.0f), c.ctrl_high);
  HoverWrench w;
  w.total = ((u[0] + u[1]) + u[2]) + u[3];
  w.mx = c.arm * (((u[0] - u[1]) - u[2]) + u[3]);
  w.my = -c.arm * (((u[0] + u[1]) - u[2]) - u[3]);
  w.mz = c.yaw_gear * (((-u[0] + u[1]) - u[2]) + u[3]);
  return w;
}

// One semi-implicit Euler substep of s = [p(3) q(4) v(3) w(3)] under the
// wrench w, in place: thrust along body z, gravity, the fluid drag at the
// CoM, the gyroscopic term, the CoM-offset origin coupling, velocities
// first, positions from the new velocities, the exp-map quaternion update.
__device__ __forceinline__ void hover_substep(float (&s)[13], const HoverParams& c,
                                              const HoverDrag& k, const HoverWrench& w) {
  const float px = s[0], py = s[1], pz = s[2];
  const float qw = s[3], qx = s[4], qy = s[5], qz = s[6];
  const float vx = s[7], vy = s[8], vz = s[9];
  const float ox = s[10], oy = s[11], oz = s[12];
  const float cz = c.cz, dt = c.dt;

  const float qn2 = qw * qw + qx * qx + qy * qy + qz * qz;
  const float inv = 1.0f / qn2;
  const float r00 = 1.0f - 2.0f * (qy * qy + qz * qz) * inv;
  const float r01 = 2.0f * (qx * qy - qz * qw) * inv;
  const float r02 = 2.0f * (qx * qz + qy * qw) * inv;
  const float r10 = 2.0f * (qx * qy + qz * qw) * inv;
  const float r11 = 1.0f - 2.0f * (qx * qx + qz * qz) * inv;
  const float r12 = 2.0f * (qy * qz - qx * qw) * inv;
  const float r20 = 2.0f * (qx * qz - qy * qw) * inv;
  const float r21 = 2.0f * (qy * qz + qx * qw) * inv;
  const float r22 = 1.0f - 2.0f * (qx * qx + qy * qy) * inv;

  float fx = r02 * w.total;
  float fy = r12 * w.total;
  float fz = r22 * w.total + c.g * c.mass;

  // Fluid drag (body frame): v_com_b = R^T v + w x c, c = (0, 0, cz).
  const float vb0 = r00 * vx + r10 * vy + r20 * vz + oy * cz;
  const float vb1 = r01 * vx + r11 * vy + r21 * vz - ox * cz;
  const float vb2 = r02 * vx + r12 * vy + r22 * vz;
  const float fb0 = -k.kv * vb0 - k.fx * fabsf(vb0) * vb0;
  const float fb1 = -k.kv * vb1 - k.fy * fabsf(vb1) * vb1;
  const float fb2 = -k.kv * vb2 - k.fz * fabsf(vb2) * vb2;
  const float tx = w.mx - k.kt * ox - k.tx * fabsf(ox) * ox;
  const float ty = w.my - k.kt * oy - k.ty * fabsf(oy) * oy;
  const float tz = w.mz - k.kt * oz - k.tz * fabsf(oz) * oz;
  fx = fx + r00 * fb0 + r01 * fb1 + r02 * fb2;
  fy = fy + r10 * fb0 + r11 * fb1 + r12 * fb2;
  fz = fz + r20 * fb0 + r21 * fb1 + r22 * fb2;

  // Gyroscopic term w x (I w).
  const float gyx = oy * (c.iz * oz) - oz * (c.iy * oy);
  const float gyy = oz * (c.ix * ox) - ox * (c.iz * oz);
  const float gyz = ox * (c.iy * oy) - oy * (c.ix * ox);
  const float odx = (tx - gyx) / c.ix;
  const float ody = (ty - gyy) / c.iy;
  const float odz = (tz - gyz) / c.iz;
  // Origin coupling: a_o = a_c - R (alpha x c + w x (w x c)).
  const float uc0 = (ody + oz * ox) * cz;
  const float uc1 = (-odx + oz * oy) * cz;
  const float uc2 = -(ox * ox + oy * oy) * cz;
  const float accx = fx / c.mass - (r00 * uc0 + r01 * uc1 + r02 * uc2);
  const float accy = fy / c.mass - (r10 * uc0 + r11 * uc1 + r12 * uc2);
  const float accz = fz / c.mass - (r20 * uc0 + r21 * uc1 + r22 * uc2);

  const float nvx = vx + accx * dt, nvy = vy + accy * dt, nvz = vz + accz * dt;
  const float nox = ox + odx * dt, noy = oy + ody * dt, noz = oz + odz * dt;

  // Exp-map quaternion update: q (x) exp(w dt / 2), renormalised.
  const float rx = nox * dt, ry = noy * dt, rz = noz * dt;
  const float ang = sqrtf(rx * rx + ry * ry + rz * rz);
  const float half = 0.5f * ang;
  const float sinc_half = ang > 1e-9f ? sinf(half) / ang : 0.5f;
  const float dw = cosf(half);
  const float ex = rx * sinc_half, ey = ry * sinc_half, ez = rz * sinc_half;
  const float mqw = qw * dw - qx * ex - qy * ey - qz * ez;
  const float mqx = qw * ex + qx * dw + qy * ez - qz * ey;
  const float mqy = qw * ey - qx * ez + qy * dw + qz * ex;
  const float mqz = qw * ez + qx * ey - qy * ex + qz * dw;
  const float inv_n = rsqrtf(mqw * mqw + mqx * mqx + mqy * mqy + mqz * mqz);

  s[0] = px + nvx * dt;
  s[1] = py + nvy * dt;
  s[2] = pz + nvz * dt;
  s[3] = mqw * inv_n;
  s[4] = mqx * inv_n;
  s[5] = mqy * inv_n;
  s[6] = mqz * inv_n;
  s[7] = nvx;
  s[8] = nvy;
  s[9] = nvz;
  s[10] = nox;
  s[11] = noy;
  s[12] = noz;
}

// The hovering reward without its action terms, and done: -10 |p -
// (0,0,1)|^2 - 0.1 |v, w|^2 + 100 is completed by the caller's - |a|^2 +
// 0.1 sum(a) (the RAW action); done = not finite, z <= 0.3, |x| >= 2 or
// |y| >= 2.  Returns the position and velocity terms, -10 P - 0.1 V.
__device__ __forceinline__ float hover_state_terms(const float (&s)[13], bool& done) {
  const float px = s[0], py = s[1], pz = s[2];
  float vel_sq = 0.0f, total = 0.0f;
#pragma unroll
  for (int i = 7; i < 13; ++i) vel_sq += s[i] * s[i];
#pragma unroll
  for (int i = 0; i < 13; ++i) total += s[i];
  const float dz = pz - 1.0f;
  done = !isfinite(total) || pz <= 0.3f || fabsf(px) >= 2.0f || fabsf(py) >= 2.0f;
  return -10.0f * (px * px + py * py + dz * dz) - 0.1f * vel_sq;
}

// The deterministic reset: (0, 0, init_z) at rest, identity attitude.
__device__ __forceinline__ void hover_reset(float (&s)[13], float init_z) {
#pragma unroll
  for (int i = 0; i < 13; ++i) s[i] = 0.0f;
  s[2] = init_z;
  s[3] = 1.0f;
}

}  // namespace reinmav
