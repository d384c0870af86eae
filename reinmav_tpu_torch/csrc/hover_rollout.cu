// K5: the hover task's throughput rollout (MujocoQuadForce-v1 under a
// constant action, with its deterministic auto-reset), written for NVIDIA
// Hopper (sm_90a).
//
// Replaces reinmav_tpu/ops/pallas_tpuquad.py::hover_rollout_pallas8 (:622,
// pallas_call :672): _hover_kernel_body (:511) with _hover_step_tiles (:449)
// and _rigid_substep(contact=False) (:348-446), over the whole horizon.  Per
// env and step: frame_skip substeps of the free body under the clipped
// constant action (thrust, arm and yaw torques, fluid drag, CoM-offset
// coupling, exp-map quaternion), the hovering reward with the RAW action,
// done = not finite, z <= 0.3, |x| >= 2 or |y| >= 2, and the reset of a done
// env to (0, 0, init_z) at rest.  No contact: the env ends at z <= 0.3 while
// its lowest point is 0.15 below the origin at most, so no live state
// reaches the plane, and resets restore z = init_z (the TPU kernel's own
// argument, :23-25).  Its plain PyTorch twin is
// reinmav_tpu_torch/ops/hover_rollout.py::hover_rollout_reference, which
// computes hover_common.cuh::hover_substep's arithmetic in its order.
//
// What bounds it on the card: instruction issue.  An env's state crosses
// device memory once per ROLLOUT (52 B in, 52 B + 4 B out), and there is no
// dependent chain to wait on (every SM holds 32 warps).  In hover_substep,
// most of the SASS of a substep (python3 -m reinmav_tpu_torch.sass_report
// counts it) is its eight IEEE divisions (each a MUFU.RCP, a Newton
// refinement, a range check and a call to a slow path) and the accurate
// sinf, cosf and sqrtf of the exp-map.
//
// What the design does about it: one thread per env; the 13 state floats
// and the reward sum stay in registers for the whole horizon; the (13, B)
// loads and stores coalesce across a warp and happen once; the 17 params are
// kernel arguments (no baked variant), the drag constants, the action's
// wrench and the reciprocals of the constant divisors are formed once per
// thread; frame_skip is a runtime count.  The ragged tail is masked, so any
// B works: there is no slicing of the batch.  The substep is
// hover_substep's arithmetic (csrc/hover_common.cuh, which K6-hover and K7
// use unchanged) with these roundings changed, each within a rounding or
// two of the twin's, so K5 is held to its twin at a tolerance (as it was
// already: nvcc contracts its products into FMAs):
//
// - 1 / |q|^2 is the approximate reciprocal (MUFU.RCP, within 1 ulp).
// - g * mass is formed once per thread (the same product).
// - The divisions by ix, iy, iz and mass are products with their
//   reciprocals, each rounded once per thread with __frcp_rn.
// - Below a rotation angle |w| dt of 0.5, sin(ang / 2) / ang and
//   cos(ang / 2) are their Taylor series in h^2 = ang^2 / 4 (to h^6 and to
//   h^8: the first terms left out are below 3e-11 and 3e-13 there), so the
//   exp-map needs no sqrtf, sinf, cosf or division; above it, the
//   library's, as hover_substep.
//
// So an edit to the physics of the rigid substep must now be made in three
// places: hover_common.cuh (K5's twin, K6-hover, K7), contact_rollout.cu
// (K11's copy) and here.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hover_common.cuh"

namespace {

using reinmav::HoverParams;

constexpr int kThreads = 256;

// Per-thread constants of K5's substep: the reciprocals of the constant
// divisors and the weight.
struct K5Consts {
  float rix, riy, riz, rmass, g_mass;
};

// hover_substep (csrc/hover_common.cuh) with the departures the header
// lists: one semi-implicit Euler substep of s = [p(3) q(4) v(3) w(3)] under
// the wrench w, in place.
__device__ __forceinline__ void k5_substep(float (&s)[13], const HoverParams& c,
                                           const reinmav::HoverDrag& k,
                                           const reinmav::HoverWrench& w, const K5Consts& r) {
  const float px = s[0], py = s[1], pz = s[2];
  const float qw = s[3], qx = s[4], qy = s[5], qz = s[6];
  const float vx = s[7], vy = s[8], vz = s[9];
  const float ox = s[10], oy = s[11], oz = s[12];
  const float cz = c.cz, dt = c.dt;

  const float qn2 = qw * qw + qx * qx + qy * qy + qz * qz;
  const float inv = __fdividef(1.0f, qn2);
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
  float fz = r22 * w.total + r.g_mass;

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
  const float odx = (tx - gyx) * r.rix;
  const float ody = (ty - gyy) * r.riy;
  const float odz = (tz - gyz) * r.riz;
  // Origin coupling: a_o = a_c - R (alpha x c + w x (w x c)).
  const float uc0 = (ody + oz * ox) * cz;
  const float uc1 = (-odx + oz * oy) * cz;
  const float uc2 = -(ox * ox + oy * oy) * cz;
  const float accx = fx * r.rmass - (r00 * uc0 + r01 * uc1 + r02 * uc2);
  const float accy = fy * r.rmass - (r10 * uc0 + r11 * uc1 + r12 * uc2);
  const float accz = fz * r.rmass - (r20 * uc0 + r21 * uc1 + r22 * uc2);

  const float nvx = vx + accx * dt, nvy = vy + accy * dt, nvz = vz + accz * dt;
  const float nox = ox + odx * dt, noy = oy + ody * dt, noz = oz + odz * dt;

  // Exp-map quaternion update: q (x) exp(w dt / 2), renormalised.
  const float rx = nox * dt, ry = noy * dt, rz = noz * dt;
  const float ang2 = rx * rx + ry * ry + rz * rz;
  float sinc_half, dw;
  if (ang2 < 0.25f) {
    const float h2 = 0.25f * ang2;
    sinc_half = 0.5f + h2 * (-1.0f / 12.0f + h2 * (1.0f / 240.0f + h2 * (-1.0f / 10080.0f)));
    dw = 1.0f + h2 * (-0.5f + h2 * (1.0f / 24.0f + h2 * (-1.0f / 720.0f + h2 * (1.0f / 40320.0f))));
  } else {
    const float ang = sqrtf(ang2);
    const float half = 0.5f * ang;
    sinc_half = sinf(half) / ang;
    dw = cosf(half);
  }
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

__global__ void __launch_bounds__(kThreads)
hover_rollout_kernel(const float* __restrict__ s_in, float* __restrict__ s_out,
                     float* __restrict__ reward_out, int64_t batch, int horizon, int frame_skip,
                     HoverParams p, float a0, float a1, float a2, float a3, float a_sq,
                     float a_sum01) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= batch) return;  // ragged tail

  const reinmav::HoverDrag k = reinmav::hover_drag(p);
  const float act[4] = {a0, a1, a2, a3};
  const reinmav::HoverWrench w = reinmav::hover_wrench(act, p);
  const K5Consts r{__frcp_rn(p.ix), __frcp_rn(p.iy), __frcp_rn(p.iz), __frcp_rn(p.mass),
                   p.g * p.mass};

  float s[13];
#pragma unroll
  for (int d = 0; d < 13; ++d) s[d] = s_in[d * batch + i];
  float reward_sum = 0.0f;

  for (int t = 0; t < horizon; ++t) {
    for (int f = 0; f < frame_skip; ++f) k5_substep(s, p, k, w, r);
    bool done;
    const float terms = reinmav::hover_state_terms(s, done);
    reward_sum += terms - a_sq + a_sum01 + 100.0f;
    if (done) reinmav::hover_reset(s, p.init_z);
  }

#pragma unroll
  for (int d = 0; d < 13; ++d) s_out[d * batch + i] = s[d];
  reward_out[i] = reward_sum;
}

}  // namespace

// C interface, bound with ctypes (reinmav_tpu_torch/_build.py).  Launches on
// the given stream, does not synchronise, and returns cudaGetLastError().
// params_host: the 17 floats of hover_params_vec; action: the 4 raw
// controls; a_sq and a_sum01: sum(a^2) and 0.1 * sum(a), rounded to float
// from double on the host, as the TPU kernel folds its Python constants.
extern "C" int hover_rollout_launch(const void* states_in, void* states_out, void* reward_out,
                                    long long batch, int horizon, int frame_skip,
                                    const void* params_host, const void* action_host, float a_sq,
                                    float a_sum01, void* stream) {
  const HoverParams p = reinmav::hover_params_from(static_cast<const float*>(params_host));
  const float* a = static_cast<const float*>(action_host);
  const long long blocks = (batch + kThreads - 1) / kThreads;
  hover_rollout_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(states_in), static_cast<float*>(states_out),
      static_cast<float*>(reward_out), batch, horizon, frame_skip, p, a[0], a[1], a[2], a[3], a_sq,
      a_sum01);
  return static_cast<int>(cudaGetLastError());
}
