// The env kinds of the policy-driven kernels, K2/K6-hover (ppo_rollout.cu,
// the fused PPO rollout) and K7 (offpolicy_collect.cu, the fused off-policy
// collection step): one struct per env with its dims, its params, the
// constants derived from them, one env step under a per-env raw action, and
// the reset of a done env.  A kernel templated on these structs takes a new
// env by adding a struct here (the JAX package's _ENVS table,
// reinmav_tpu/ops/pallas_ppo_rollout.py:516).
//
// Kind ids are the ones of reinmav_tpu_torch/ops/ppo_rollout.py::ENVS.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "hover_common.cuh"
#include "quad3d_common.cuh"

namespace reinmav {

constexpr int kEnvActionDim = 4;  // both kinds so far

// quadrotor3d-v0 (_quad3d_step_tiles): thrust / mass keeps the scan's op
// order; done envs redraw U(-1, 1)^10 from the given Philox stream.
struct Quad3dEnv {
  static constexpr int kD = 10;
  static constexpr int kA = kEnvActionDim;
  static constexpr int kKind = 0;
  using Params = Quad3dParams;
  struct Consts {
    float half_dt, pos_lim2, vel_lim2;
  };
  static Params params(const float* h) {
    return Params{h[0], h[1], h[2], h[3], h[4], h[5], h[6], h[7], h[8], h[9], h[10]};
  }
  static constexpr int kParams = 11;
  __device__ static Consts consts(const Params& p) {
    return {0.5f * p.dt, p.pos_limit * p.pos_limit, p.vel_limit * p.vel_limit};
  }
  __device__ static float step(float (&s)[kD], const float (&act)[kA], const Params& p,
                               const Consts& c, bool& done) {
    const BodyZ bz = body_z(s);
    return quad3d_dynamics(s, bz, act[0] / p.mass, act[1], act[2], act[3], p.dt, p.gravity,
                           c.half_dt, c.pos_lim2, c.vel_lim2, done);
  }
  __device__ static void reset(float (&s)[kD], uint32_t env, uint32_t t, uint32_t seed,
                               uint32_t stream, const Params&) {
    reset_uniform10(s, env, t, seed, stream);
  }
};

// MujocoQuadForce-v1 (_hover_step_tiles with per-lane actions): two
// substeps under the clipped action, the hovering reward with the RAW
// action, the deterministic reset to (0, 0, init_z) (no draws).
struct HoverEnv {
  static constexpr int kD = 13;
  static constexpr int kA = kEnvActionDim;
  static constexpr int kKind = 1;
  using Params = HoverParams;
  using Consts = HoverDrag;
  static Params params(const float* h) { return hover_params_from(h); }
  static constexpr int kParams = kHoverParams;
  __device__ static Consts consts(const Params& p) { return hover_drag(p); }
  __device__ static float step(float (&s)[kD], const float (&act)[kA], const Params& p,
                               const Consts& c, bool& done) {
    const HoverWrench w = hover_wrench(act, p);
    hover_substep(s, p, c, w);
    hover_substep(s, p, c, w);
    const float terms = hover_state_terms(s, done);
    const float a_sq = act[0] * act[0] + act[1] * act[1] + act[2] * act[2] + act[3] * act[3];
    const float a_sum = act[0] + act[1] + act[2] + act[3];
    return terms - a_sq + 0.1f * a_sum + 100.0f;
  }
  __device__ static void reset(float (&s)[kD], uint32_t, uint32_t, uint32_t, uint32_t,
                               const Params& p) {
    hover_reset(s, p.init_z);
  }
};

}  // namespace reinmav
