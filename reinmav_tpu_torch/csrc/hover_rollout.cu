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
// argument, :23-25).  Its plain PyTorch twin, the same arithmetic in the same
// order, is reinmav_tpu_torch/ops/hover_rollout.py::hover_rollout_reference.
//
// What bounds it on the card: arithmetic.  One env-step is two substeps of
// about 257 FP32 operations each (a sin, a cos, a sqrt, an rsqrt and eight
// divisions among them) and the reward, while an env's state crosses device
// memory once per ROLLOUT: 52 B in, 52 B + 4 B out.
//
// What the design does about it: one thread per env; the 13 state floats
// and the reward sum stay in registers for the whole horizon; the (13, B)
// loads and stores coalesce across a warp and happen once; the 17 params are
// kernel arguments (no baked variant), the drag constants and the action's
// wrench are formed once per thread; frame_skip is a runtime count.  The
// ragged tail is masked, so any B works: there is no slicing of the batch.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hover_common.cuh"

namespace {

using reinmav::HoverParams;

constexpr int kThreads = 256;

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

  float s[13];
#pragma unroll
  for (int d = 0; d < 13; ++d) s[d] = s_in[d * batch + i];
  float reward_sum = 0.0f;

  for (int t = 0; t < horizon; ++t) {
    for (int f = 0; f < frame_skip; ++f) reinmav::hover_substep(s, p, k, w);
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
