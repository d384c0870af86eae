// K1: the quadrotor3d closed-loop rollout with fused auto-reset, written for
// NVIDIA Hopper (sm_90a).
//
// Replaces reinmav_tpu/ops/pallas_rollout.py::quad3d_rollout_autoreset_pallas8
// (:591): the step of _closed_loop_step_tiles (:310) with
// tilt_controller_tiles (:241) inside it, repeated over the whole horizon,
// and the U(-1,1)^10 redraw of done envs (_uniform_pm1 :206, applied at
// :440-444).  With autoreset = 0 it is quad3d_rollout_pallas (:359), the
// no-reset variant.  Its plain PyTorch twin, which computes the same thing
// in the same order, is reinmav_tpu_torch/ops/rollout.py::
// quad3d_rollout_reference.
//
// What bounds it on the card: arithmetic.  One env-step is about 150 fp32
// operations (three rsqrt and one sqrt among them), while an env's state
// crosses device memory once per ROLLOUT: 40 B in, 40 B + 4 B (reward sum)
// out.  At a 1000-step horizon that is under 0.1 B of traffic per env-step,
// far on the compute side of the H100's roofline.
//
// What the design does about it: one thread per env; the 10 state floats and
// the reward sum stay in registers across the whole horizon; the (10, B)
// loads and stores coalesce across a warp and happen once at the start and
// once at the end; the 11 params are kernel arguments (the TPU kernel's
// SMEM-versus-baked duality is gone).  A done env redraws its state from
// Philox4x32-10 (quad3d_common.cuh, shared with K2) with key (seed, 0) and counter
// (env index, step, draw index, 0): three draws give the 10 values.  The
// draw runs only on the rare done branch.  The ragged tail of the batch is
// masked, so any B works.  Speeding it up (several envs per thread for
// instruction-level parallelism, cheaper intrinsics) is later work.

#include <cuda_runtime.h>
#include <stdint.h>

#include "quad3d_common.cuh"

namespace {

using reinmav::Quad3dParams;

constexpr int kThreads = 256;

// One controller + dynamics step on s = [px py pz qw qx qy qz vx vy vz].
// Returns the step's reward and sets done.
__device__ __forceinline__ float closed_loop_step(float (&s)[10], const Quad3dParams& p,
                                                  float two_over_tau, float inv_m,
                                                  float half_dt, float pos_lim2,
                                                  float vel_lim2, bool& done) {
  // ---- geometric controller (tilt_controller_tiles) ----------------------
  const reinmav::GeometricCmd cmd = reinmav::geometric_control(
      s, p.kp, p.kv, p.ref_x, p.ref_y, p.ref_z, p.gravity, two_over_tau);
  // ---- dynamics (envs/quadrotor3d.py:step) --------------------------------
  return reinmav::quad3d_dynamics(s, cmd.bz, cmd.thrust * inv_m, cmd.wx, cmd.wy, cmd.wz, p.dt,
                                  p.gravity, half_dt, pos_lim2, vel_lim2, done);
}

__global__ void __launch_bounds__(kThreads)
quad3d_rollout_kernel(const float* __restrict__ s_in, float* __restrict__ s_out,
                      float* __restrict__ reward_out, int64_t batch, int horizon,
                      uint32_t seed, int autoreset, Quad3dParams p) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= batch) return;  // ragged tail

  const float two_over_tau = 2.0f / p.tau;
  const float inv_m = 1.0f / p.mass;
  const float half_dt = 0.5f * p.dt;
  const float pos_lim2 = p.pos_limit * p.pos_limit;
  const float vel_lim2 = p.vel_limit * p.vel_limit;
  const uint32_t env = static_cast<uint32_t>(i);

  float s[10];
#pragma unroll
  for (int d = 0; d < 10; ++d) s[d] = s_in[d * batch + i];
  float reward_sum = 0.0f;

  for (int t = 0; t < horizon; ++t) {
    bool done;
    reward_sum += closed_loop_step(s, p, two_over_tau, inv_m, half_dt, pos_lim2, vel_lim2, done);
    if (autoreset && done) {
      reinmav::reset_uniform(s, env, static_cast<uint32_t>(t), seed, 0u);
    }
  }

#pragma unroll
  for (int d = 0; d < 10; ++d) s_out[d * batch + i] = s[d];
  reward_out[i] = reward_sum;
}

// Philox4x32-10 on n (counter, key) pairs: the known-answer check of the
// generator the rollout kernel draws its resets from.
__global__ void philox4x32_10_kernel(const uint32_t* __restrict__ ctr,
                                     const uint32_t* __restrict__ key,
                                     uint32_t* __restrict__ out, int64_t n) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const uint4 c = make_uint4(ctr[4 * i], ctr[4 * i + 1], ctr[4 * i + 2], ctr[4 * i + 3]);
  const uint4 r = reinmav::philox4x32_10(c, key[2 * i], key[2 * i + 1]);
  out[4 * i] = r.x;
  out[4 * i + 1] = r.y;
  out[4 * i + 2] = r.z;
  out[4 * i + 3] = r.w;
}

}  // namespace

// C interface, bound with ctypes (reinmav_tpu_torch/_build.py).  Each entry
// point launches on the given stream, does not synchronise, and returns
// cudaGetLastError().

extern "C" int quad3d_rollout_launch(const void* states_in, void* states_out, void* reward_out,
                                     long long batch, int horizon, unsigned int seed,
                                     int autoreset, const void* params_host, void* stream) {
  const float* h = static_cast<const float*>(params_host);
  const Quad3dParams p{h[0], h[1], h[2], h[3], h[4], h[5], h[6], h[7], h[8], h[9], h[10]};
  const long long blocks = (batch + kThreads - 1) / kThreads;
  quad3d_rollout_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(states_in), static_cast<float*>(states_out),
      static_cast<float*>(reward_out), batch, horizon, seed, autoreset, p);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int philox4x32_10_launch(const void* counters, const void* keys, void* out,
                                    long long n, void* stream) {
  const long long blocks = (n + kThreads - 1) / kThreads;
  philox4x32_10_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(counters), static_cast<const uint32_t*>(keys),
      static_cast<uint32_t*>(out), n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
