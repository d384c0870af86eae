// The env kinds of the port's templated kernels: K2/K6 (ppo_rollout.cu, the
// fused PPO rollout), K7 (offpolicy_collect.cu, the fused off-policy
// collection step) and K8/K9 (closed_loop_rollout.cu, the closed loops
// under the classical controllers).  One struct per env with its dims
// (kD state = obs, kA action), its params, the constants derived from
// them, one env step under a per-env raw action, the classical controller
// where the env has one, and the reset of a done env.  A kernel templated on
// these structs takes a new env by adding a struct here (the JAX package's
// _ENVS table, reinmav_tpu/ops/pallas_ppo_rollout.py:516).
//
// Kind ids are the ones of reinmav_tpu_torch/ops/ppo_rollout.py::ENVS.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "hover_common.cuh"
#include "quad2d_common.cuh"
#include "quad3d_common.cuh"
#include "slung_common.cuh"

namespace reinmav {

// quadrotor3d-v0 (_quad3d_step_tiles): thrust / mass keeps the scan's op
// order; done envs redraw U(-1, 1)^10 from the given Philox stream.
struct Quad3dEnv {
  static constexpr int kD = 10;
  static constexpr int kA = 4;
  static constexpr int kKind = 0;
  using Params = Quad3dParams;
  struct Consts {
    float half_dt, pos_lim2, vel_lim2, two_over_tau;
  };
  static Params params(const float* h) {
    return Params{h[0], h[1], h[2], h[3], h[4], h[5], h[6], h[7], h[8], h[9], h[10]};
  }
  static constexpr int kParams = 11;
  __device__ static Consts consts(const Params& p) {
    return {0.5f * p.dt, p.pos_limit * p.pos_limit, p.vel_limit * p.vel_limit, 2.0f / p.tau};
  }
  __device__ static void control(const float (&s)[kD], const Params& p, const Consts& c,
                                 float (&act)[kA]) {
    const GeometricCmd cmd =
        geometric_control(s, p.kp, p.kv, p.ref_x, p.ref_y, p.ref_z, p.gravity, c.two_over_tau);
    act[0] = cmd.thrust; act[1] = cmd.wx; act[2] = cmd.wy; act[3] = cmd.wz;
  }
  __device__ static float step(float (&s)[kD], const float (&act)[kA], const Params& p,
                               const Consts& c, bool& done) {
    const BodyZ bz = body_z(s);
    return quad3d_dynamics(s, bz, act[0] / p.mass, act[1], act[2], act[3], p.dt, p.gravity,
                           c.half_dt, c.pos_lim2, c.vel_lim2, done);
  }
  __device__ static void reset(float (&s)[kD], uint32_t env, uint32_t t, uint32_t seed,
                               uint32_t stream, const Params&) {
    reset_uniform(s, env, t, seed, stream);
  }
};

// MujocoQuadForce-v1 (_hover_step_tiles with per-lane actions): two
// substeps under the clipped action, the hovering reward with the RAW
// action, the deterministic reset to (0, 0, init_z) (no draws).  No
// classical controller.
struct HoverEnv {
  static constexpr int kD = 13;
  static constexpr int kA = 4;
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

// quadrotor2d-v0: the step of pallas_ppo_rollout.py::_quad2d_step_tiles
// (:205), the controller of pallas_rollout.py::_quad2d_step_tiles (:520),
// the U(-1, 1)^5 reset.
struct Quad2dEnv {
  static constexpr int kD = 5;
  static constexpr int kA = 2;
  static constexpr int kKind = 2;
  using Params = Quad2dParams;
  struct Consts {
    float neg_inv_tau;
  };
  static Params params(const float* h) {
    return Params{h[0], h[1], h[2], h[3], h[4], h[5], h[6], h[7], h[8], h[9], h[10]};
  }
  static constexpr int kParams = 11;
  __device__ static Consts consts(const Params& p) { return {-1.0f / p.tau}; }
  __device__ static void control(const float (&s)[kD], const Params& p, const Consts& c,
                                 float (&act)[kA]) {
    pd2d_control(s[0], s[1], s[2], s[3], s[4], p.kp, p.kv, p.ref_x, p.ref_z, c.neg_inv_tau,
                 p.mass, act[0], act[1]);
  }
  __device__ static float step(float (&s)[kD], const float (&act)[kA], const Params& p,
                               const Consts&, bool& done) {
    return quad2d_step(s, act[0], act[1], p, done);
  }
  __device__ static void reset(float (&s)[kD], uint32_t env, uint32_t t, uint32_t seed,
                               uint32_t stream, const Params&) {
    reset_uniform(s, env, t, seed, stream);
  }
};

// quadrotor2d-slungload-v0: slung_common.cuh's step (velocity-first), the
// planar PD controller on the quad state (pallas_slungload.py::
// _slung2d_step_tiles :208), the U(-1, 1)^9 reset.
struct Slung2dEnv {
  static constexpr int kD = 9;
  static constexpr int kA = 2;
  static constexpr int kKind = 3;
  using Params = Slung2dParams;
  struct Consts {
    float neg_inv_tau, inv_mml;
  };
  static Params params(const float* h) {
    return Params{h[0], h[1], h[2], h[3], h[4], h[5], h[6], h[7], h[8], h[9], h[10], h[11]};
  }
  static constexpr int kParams = 12;
  __device__ static Consts consts(const Params& p) {
    return {-1.0f / p.tau, 1.0f / (p.mass + p.load_mass)};
  }
  __device__ static void control(const float (&s)[kD], const Params& p, const Consts& c,
                                 float (&act)[kA]) {
    pd2d_control(s[0], s[1], s[2], s[3], s[4], p.kp, p.kv, p.ref_x, p.ref_z, c.neg_inv_tau,
                 p.mass, act[0], act[1]);
  }
  __device__ static float step(float (&s)[kD], const float (&act)[kA], const Params& p,
                               const Consts& c, bool& done) {
    return slung2d_step(s, act[0], act[1], p, c.inv_mml, done);
  }
  __device__ static void reset(float (&s)[kD], uint32_t env, uint32_t t, uint32_t seed,
                               uint32_t stream, const Params&) {
    reset_uniform(s, env, t, seed, stream);
  }
};

// quadrotor3d-slungload-v0: slung_common.cuh's step (position-first), the
// geometric controller on the quad state (pallas_slungload.py::
// _slung3d_step_tiles :76), the U(-1, 1)^16 reset.
struct Slung3dEnv {
  static constexpr int kD = 16;
  static constexpr int kA = 4;
  static constexpr int kKind = 4;
  using Params = Slung3dParams;
  struct Consts {
    float half_dt, inv_mml, two_over_tau;
  };
  static Params params(const float* h) {
    return Params{h[0], h[1], h[2], h[3], h[4], h[5], h[6],
                  h[7], h[8], h[9], h[10], h[11], h[12]};
  }
  static constexpr int kParams = 13;
  __device__ static Consts consts(const Params& p) {
    return {0.5f * p.dt, 1.0f / (p.mass + p.load_mass), 2.0f / p.tau};
  }
  __device__ static void control(const float (&s)[kD], const Params& p, const Consts& c,
                                 float (&act)[kA]) {
    const GeometricCmd cmd =
        geometric_control(s, p.kp, p.kv, p.ref_x, p.ref_y, p.ref_z, p.gravity, c.two_over_tau);
    act[0] = cmd.thrust; act[1] = cmd.wx; act[2] = cmd.wy; act[3] = cmd.wz;
  }
  __device__ static float step(float (&s)[kD], const float (&act)[kA], const Params& p,
                               const Consts& c, bool& done) {
    return slung3d_step(s, act[0], act[1], act[2], act[3], p, c.half_dt, c.inv_mml, done);
  }
  __device__ static void reset(float (&s)[kD], uint32_t env, uint32_t t, uint32_t seed,
                               uint32_t stream, const Params&) {
    reset_uniform(s, env, t, seed, stream);
  }
};

// f(Env{}) for the struct of kind id `kind`, over the policy-driven kinds
// (every struct above); cudaErrorInvalidValue for another id.
template <class F>
cudaError_t with_env_kind(int kind, F&& f) {
  switch (kind) {
    case Quad3dEnv::kKind: return f(Quad3dEnv{});
    case HoverEnv::kKind: return f(HoverEnv{});
    case Quad2dEnv::kKind: return f(Quad2dEnv{});
    case Slung2dEnv::kKind: return f(Slung2dEnv{});
    case Slung3dEnv::kKind: return f(Slung3dEnv{});
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace reinmav
