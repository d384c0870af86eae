// Device code of the planar envs: the quadrotor2d params, the planar PD
// controller that quadrotor2d-v0 and quadrotor2d-slungload-v0 share
// (reinmav_tpu/envs/quadrotor2d.py:control), and the quadrotor2d step
// (reinmav_tpu/envs/quadrotor2d.py:step).  Used through the env structs of
// env_kinds.cuh by K8 (closed_loop_rollout.cu), K6 (ppo_rollout.cu) and K7
// (offpolicy_collect.cu).  The plain PyTorch twins write the same
// arithmetic in reinmav_tpu_torch/ops/closed_loop_rollout.py.

#pragma once

#include <cuda_runtime.h>

namespace reinmav {

constexpr float kHalfPi = 1.57079632679489662f;

// Field order of reinmav_tpu_torch/envs/quadrotor2d.py::Params (_Q2_FIELDS).
struct Quad2dParams {
  float mass, dt, gravity, ref_x, ref_z, pos_limit, vel_limit, kp, kv, tau, thrust_scale;
};

// The planar PD controller (pallas_rollout.py::_quad2d_step_tiles :533-540):
// PD acceleration with the reference's hard-coded +9.8 lift (NOT -gravity),
// an atan2 attitude target, a first-order rate loop.  CUDA's atan2f stands
// in for the TPU kernel's polynomial _atan2, which exists only because
// Mosaic cannot lower atan2.  Thrust in Newtons.
__device__ __forceinline__ void pd2d_control(float x, float z, float th, float vx, float vz,
                                             float kp, float kv, float ref_x, float ref_z,
                                             float neg_inv_tau, float mass, float& thrust,
                                             float& w) {
  const float dax = kp * (x - ref_x) + kv * vx;
  const float daz = kp * (z - ref_z) + kv * vz + 9.8f;
  const float des_att = atan2f(daz, dax) - kHalfPi;
  w = neg_inv_tau * (th - des_att);
  thrust = mass * sqrtf(dax * dax + daz * daz);
}

// One quadrotor2d step on s = [x z th vx vz] under [thrust_cmd, omega]
// (pallas_ppo_rollout.py::_quad2d_step_tiles :205): the thrust_scale gain
// floored at 0 (Q5), position-first Euler with the old velocity (Q3), done
// on |p| > pos_limit, |v| > 10 (the reference's folded predicate, kept
// under a vel_limit sweep) or |v| > vel_limit.  Returns the reward.
__device__ __forceinline__ float quad2d_step(float (&s)[5], float a0, float a1,
                                             const Quad2dParams& p, bool& done) {
  const float x = s[0], z = s[1], th = s[2], vx = s[3], vz = s[4];
  const float dt = p.dt;
  const float tq = fmaxf(p.thrust_scale * a0, 0.0f) / p.mass;
  float hz, hx;
  sincosf(th + kHalfPi, &hz, &hx);
  const float ax = tq * hx;
  const float az = tq * hz + p.gravity;
  const float nx = x + vx * dt + 0.5f * ax * dt * dt;
  const float nz = z + vz * dt + 0.5f * az * dt * dt;
  const float nvx = vx + ax * dt;
  const float nvz = vz + az * dt;
  s[0] = nx; s[1] = nz; s[2] = th + a1 * dt; s[3] = nvx; s[4] = nvz;
  const float pn = sqrtf(nx * nx + nz * nz);
  const float vn = sqrtf(nvx * nvx + nvz * nvz);
  done = (pn > p.pos_limit) || (vn > 10.0f) || (vn > p.vel_limit);
  return done ? 1.0f : -pn;
}

}  // namespace reinmav
