// K8 and K9: the closed-loop rollouts of quadrotor2d-v0 (K8) and of the two
// slung-load envs (K9) with fused auto-reset, one template on the env structs
// of env_kinds.cuh, written for NVIDIA Hopper (sm_90a).
//
// Replaces reinmav_tpu/ops/pallas_rollout.py::component_rollout (:468,
// pallas_call :492), the scaffold that runs
//   K8  pallas_rollout.py::quad2d_rollout_autoreset_pallas8 (:567), step
//       _quad2d_step_tiles (:520);
//   K9  pallas_slungload.py::slung3d_rollout_pallas8 (:310) and
//       slung2d_rollout_pallas8 (:332), steps _slung3d_step_tiles (:76) and
//       _slung2d_step_tiles (:208);
// each env's classical controller and dynamics repeated over the whole
// horizon, with the U(-1, 1)^D redraw of done envs.  With autoreset = 0 it
// is the no-reset form.  Its plain PyTorch twin, which computes the same
// thing in the same order with the same Philox draws, is
// reinmav_tpu_torch/ops/closed_loop_rollout.py::closed_loop_rollout_reference.
// quadrotor3d-v0's closed loop stays K1 (quad3d_rollout.cu).
//
// What bounds it on the card: arithmetic.  One env-step is about 40 (quad2d),
// 90 (slung2d) or 230 (slung3d) FP32 operations, an atan2 or a sin/cos pair
// among them, while an env's state crosses device memory once per ROLLOUT:
// 4 D B in and 4 D + 4 B out, under 0.1 B per env-step at 1000 steps.
//
// What the design does about it: one thread per env; the D state floats and
// the reward sum stay in registers for the whole horizon; one coalesced (D,
// B) load and store; the env's params are kernel arguments (a param sweep
// runs here, with no baked-constant variant).  A done env redraws its state
// from Philox4x32-10 with key (seed, 0) and counter (env, step, draw, 0),
// ceil(D / 4) draws, as K1 does.  quad2d flies with its 10x thrust gain, so
// its envs end often: the redraw branch diverges warps there.  The ragged
// tail is masked, so any B works.

#include <cuda_runtime.h>
#include <stdint.h>

#include "env_kinds.cuh"

namespace {

constexpr int kThreads = 256;

template <class Env>
__global__ void __launch_bounds__(kThreads)
closed_loop_kernel(const float* __restrict__ s_in, float* __restrict__ s_out,
                   float* __restrict__ reward_out, int64_t batch, int horizon, uint32_t seed,
                   int autoreset, typename Env::Params p) {
  constexpr int kD = Env::kD;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= batch) return;  // ragged tail
  const typename Env::Consts c = Env::consts(p);
  const uint32_t env = static_cast<uint32_t>(i);

  float s[kD];
#pragma unroll
  for (int d = 0; d < kD; ++d) s[d] = s_in[d * batch + i];
  float reward_sum = 0.0f;

  for (int t = 0; t < horizon; ++t) {
    float act[Env::kA];
    Env::control(s, p, c, act);
    bool done;
    reward_sum += Env::step(s, act, p, c, done);
    if (autoreset && done) Env::reset(s, env, static_cast<uint32_t>(t), seed, 0u, p);
  }

#pragma unroll
  for (int d = 0; d < kD; ++d) s_out[d * batch + i] = s[d];
  reward_out[i] = reward_sum;
}

template <class Env>
cudaError_t launch(const float* s_in, float* s_out, float* reward_out, int64_t batch,
                   int horizon, uint32_t seed, int autoreset, const float* params_host,
                   int n_params, cudaStream_t stream) {
  if (n_params != Env::kParams || batch <= 0) return cudaErrorInvalidValue;
  const auto blocks = static_cast<unsigned int>((batch + kThreads - 1) / kThreads);
  closed_loop_kernel<Env><<<blocks, kThreads, 0, stream>>>(s_in, s_out, reward_out, batch,
                                                           horizon, seed, autoreset,
                                                           Env::params(params_host));
  return cudaGetLastError();
}

}  // namespace

// C interface, bound with ctypes (reinmav_tpu_torch/_build.py).  Launches on
// the given stream, does not synchronise, and returns a CUDA error code.
// env_kind: 2 quadrotor2d-v0 (params_host: the 11 floats of
// quad2d_params_vec, states (5, B)), 3 quadrotor2d-slungload-v0 (12 floats,
// (9, B)), 4 quadrotor3d-slungload-v0 (13 floats, (16, B)); any other kind,
// or another number of params, is refused with cudaErrorInvalidValue and
// nothing runs.
extern "C" int closed_loop_rollout_launch(int env_kind, const void* states_in, void* states_out,
                                          void* reward_out, long long batch, int horizon,
                                          unsigned int seed, int autoreset,
                                          const void* params_host, int n_params, void* stream) {
  const auto* s_in = static_cast<const float*>(states_in);
  auto* s_out = static_cast<float*>(states_out);
  auto* r_out = static_cast<float*>(reward_out);
  const auto* h = static_cast<const float*>(params_host);
  const auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (env_kind) {
    case reinmav::Quad2dEnv::kKind:
      err = launch<reinmav::Quad2dEnv>(s_in, s_out, r_out, batch, horizon, seed, autoreset, h,
                                       n_params, st);
      break;
    case reinmav::Slung2dEnv::kKind:
      err = launch<reinmav::Slung2dEnv>(s_in, s_out, r_out, batch, horizon, seed, autoreset, h,
                                        n_params, st);
      break;
    case reinmav::Slung3dEnv::kKind:
      err = launch<reinmav::Slung3dEnv>(s_in, s_out, r_out, batch, horizon, seed, autoreset, h,
                                        n_params, st);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
