// K8 and K9: the closed-loop rollouts of quadrotor2d-v0 (K8) and of the two
// slung-load envs (K9) with fused auto-reset, one template on the three loop
// structs of this file (env_kinds.cuh's env structs with their own steps),
// written for NVIDIA Hopper (sm_90a).
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
// reinmav_tpu_torch/ops/closed_loop_rollout.py::closed_loop_rollout_reference
// (its steps: LOOP_STEPS there).  quadrotor3d-v0's closed loop stays K1
// (quad3d_rollout.cu).
//
// What bounds it on the card: instruction issue.  One env-step is about 60
// (quad2d), 140 (slung2d) or 300 (slung3d) FP32 operations, an atan2 and a
// sin/cos pair among them, while an env's state crosses device memory once
// per ROLLOUT: 4 D B in and 4 D + 4 B out, under 0.1 B per env-step at 1000
// steps.
//
// What the design does about it:
// - One thread per env; the D state floats and the reward sum stay in
//   registers for the whole horizon; one coalesced (D, B) load and store;
//   the env's params are kernel arguments (a param sweep runs here, with no
//   baked-constant variant).
// - The loop structs run the TPU kernels' own steps, operation for
//   operation, not the policy kernels' (K6 and K7 keep those, in
//   quad2d_common.cuh and slung_common.cuh, byte for byte: moving their FMA
//   choices once failed the SAC learning gate).  So a physics edit of these
//   envs is now made in two places: here and in those headers, each with its
//   twin in ops/closed_loop_rollout.py (LOOP_STEPS here, KINDS there).
//   Where these steps depart from quad2d_common.cuh::quad2d_step and
//   slung_common.cuh's slung2d_step / slung3d_step:
//   * 1 / mass is formed once per thread with __frcp_rn (the bits of 1.0f /
//     mass) and the steps multiply by it: thrust * inv_m * h and, for the
//     tether's pull on the quad, tmag * u * inv_m, where the headers divide
//     by mass every step (equal bits when mass is a power of two);
//   * done compares squared norms with squared limits (quad2d keeps the
//     folded |v|^2 > 100), where the headers compare norms; the one sqrtf
//     left is the reward's;
//   * the tether has no branch (below); on a slack env its results are the
//     slack branch's bit for bit, except that a -0 in x + 0 becomes +0.
//   The controllers are the shared pd2d_control and geometric_control, with
//   CUDA's accurate atan2f, sincosf and sqrtf.
// - One branch-free tether body.  The TPU kernels compute both branches and
//   select per lane; a thread that took its own branch diverged in nearly
//   every warp, since a taut env's load sits on the tether sphere, where
//   rounding picks the branch of the next step.  Here the slack branch is
//   the taut branch's Euler update with the load's acceleration selected to
//   (0, g) or (0, 0, g) and the tension term selected to 0, so the update
//   runs once; the projection onto the sphere runs for every env and its
//   result is selected.  Selected, never multiplied by zero: a slack env's
//   tether direction may be non-finite.  The taut test stays
//   sqrtf(|load - quad|^2) >= L, the JAX kernels' own.
// - The knife edge rounded as the twin rounds it.  After a taut step the
//   load sits on the sphere, and the next taut test is decided by rounding
//   alone: of the projection's norm, of load = quad + dir * L and of the
//   tether norm.  nvcc contracts a * b + c into one FMA (one rounding), the
//   twin rounds twice, and that shifts the share of taut steps by points
//   (PERF.md), so these three are written with __fmul_rn / __fadd_rn, which
//   are never contracted; the rest of the step keeps its FMAs.
// - The reset is K1's: a done env redraws its state from Philox4x32-10 with
//   key (seed, 0) and counter (env, step, draw, 0), ceil(D / 4) blocks, on
//   its own lane (ops/rollout.py::reset_draws).  A lane that idles costs no
//   issue slot, so a warp-cooperative form (the blocks of all the done lanes
//   of a warp spread over its 32 lanes, gathered with shuffles) saves at most
//   ceil(D / 4) - 1 blocks a warp that resets, and costs registers and a
//   nested loop on every step: on an H100 it ran slower for quad2d and
//   slung3d, barely faster for slung2d, and was taken out (PERF.md).  The
//   ragged tail is masked, so any B works.
// - An optional per-env int32 count (taut env-steps for the slung kinds,
//   done env-steps, which are the resets, for quad2d), in a template
//   instance of its own, so the main path (no counts) carries none of it.

#include <cuda_runtime.h>
#include <stdint.h>

#include "env_kinds.cuh"
#include "quad2d_common.cuh"
#include "quad3d_common.cuh"
#include "slung_common.cuh"

namespace {

using reinmav::BodyZ;
using reinmav::kHalfPi;

constexpr int kThreads = 256;

// quadrotor2d-v0: _quad2d_step_tiles (pallas_rollout.py:520-563).  The env
// struct of env_kinds.cuh (dims, kind id, params, controller) with the TPU
// kernel's own step.
struct Quad2dLoop : reinmav::Quad2dEnv {
  struct Consts : reinmav::Quad2dEnv::Consts {
    float inv_m, pos_lim2, vel_lim2;
  };
  __device__ static Consts consts(const Params& p) {
    return {reinmav::Quad2dEnv::consts(p), __frcp_rn(p.mass), p.pos_limit * p.pos_limit,
            p.vel_limit * p.vel_limit};
  }
  // counted: the step ended the env (a reset, with auto-reset on).
  __device__ static float step(float (&s)[kD], const float (&act)[kA], const Params& p,
                               const Consts& c, bool& done, bool& counted) {
    const float x = s[0], z = s[1], th = s[2], vx = s[3], vz = s[4];
    const float dt = p.dt;
    const float tm = fmaxf(p.thrust_scale * act[0], 0.0f) * c.inv_m;
    float hz, hx;
    sincosf(th + kHalfPi, &hz, &hx);
    const float ax = tm * hx;
    const float az = tm * hz + p.gravity;
    const float nx = x + vx * dt + 0.5f * ax * dt * dt;  // old velocity (Q3)
    const float nz = z + vz * dt + 0.5f * az * dt * dt;
    const float nvx = vx + ax * dt;
    const float nvz = vz + az * dt;
    s[0] = nx; s[1] = nz; s[2] = th + act[1] * dt; s[3] = nvx; s[4] = nvz;
    const float pn2 = nx * nx + nz * nz;
    const float vn2 = nvx * nvx + nvz * nvz;
    done = (pn2 > c.pos_lim2) || (vn2 > 100.0f) || (vn2 > c.vel_lim2);
    counted = done;
    return done ? 1.0f : -sqrtf(pn2);
  }
};

// quadrotor2d-slungload-v0: _slung2d_step_tiles (pallas_slungload.py:208-302),
// velocity-first Euler, on env_kinds.cuh's struct.
struct Slung2dLoop : reinmav::Slung2dEnv {
  struct Consts : reinmav::Slung2dEnv::Consts {
    float inv_m, pos_lim2, vel_lim2;
  };
  __device__ static Consts consts(const Params& p) {
    return {reinmav::Slung2dEnv::consts(p), __frcp_rn(p.mass), p.pos_limit * p.pos_limit,
            p.vel_limit * p.vel_limit};
  }
  // counted: the tether was taut at the start of the step.
  __device__ static float step(float (&s)[kD], const float (&act)[kA], const Params& p,
                               const Consts& c, bool& done, bool& counted) {
    const float x = s[0], z = s[1], th = s[2], vx = s[3], vz = s[4];
    const float lx = s[5], lz = s[6], lvx = s[7], lvz = s[8];
    const float thrust = act[0], w = act[1];
    const float dt = p.dt, g = p.gravity, L = p.tether_length, m = p.mass;
    float hz, hx;
    sincosf(th + kHalfPi, &hz, &hx);

    const float tx = lx - x, tz = lz - z;
    const float tn = sqrtf(__fadd_rn(__fmul_rn(tx, tx), __fmul_rn(tz, tz)));  // the knife edge
    const float inv = reinmav::safe_inv(tn);
    const float ux = tx * inv, uz = tz * inv;
    const bool taut = tn >= L;

    // The load: the taut branch's acceleration, free fall when slack.
    const float sc = m * L * (lvx * lvx + lvz * lvz);  // a scalar subtracted from a vector
    const float proj = ux * (thrust * hx - sc) + uz * (thrust * hz - sc);
    const float lax_t = proj * ux * c.inv_mml;
    const float laz_t = proj * uz * c.inv_mml + g;
    const float lax = taut ? lax_t : 0.0f;
    const float laz = taut ? laz_t : g;
    const float nlvx = lvx + lax * dt;  // velocity FIRST (Q3)
    const float nlvz = lvz + laz * dt;
    const float nlx = lx + nlvx * dt + 0.5f * lax * dt * dt;
    const float nlz = lz + nlvz * dt + 0.5f * laz * dt * dt;

    // The quad: thrust and the tether's pull, none when slack.
    const float dzg = laz_t - g;
    const float tmag = p.load_mass * sqrtf(lax_t * lax_t + dzg * dzg);
    const float fx = taut ? tmag * ux * c.inv_m : 0.0f;
    const float fz = taut ? tmag * uz * c.inv_m : 0.0f;
    const float tm = thrust * c.inv_m;
    const float ax = tm * hx + fx;
    const float az = tm * hz + g + fz;
    const float nvx = vx + ax * dt;
    const float nvz = vz + az * dt;
    const float npx = x + nvx * dt + 0.5f * ax * dt * dt;
    const float npz = z + nvz * dt + 0.5f * az * dt * dt;

    // The kinematic projection onto the tether circle, kept when taut.
    const float dx = nlx - npx, dz = nlz - npz;
    const float dinv = reinmav::safe_inv(sqrtf(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dz, dz))));
    const float ddx = dx * dinv, ddz = dz * dinv;
    const float rad = (nlvx - nvx) * ddx + (nlvz - nvz) * ddz;
    s[0] = npx; s[1] = npz; s[2] = th + w * dt; s[3] = nvx; s[4] = nvz;
    s[5] = taut ? __fadd_rn(npx, __fmul_rn(ddx, L)) : nlx;
    s[6] = taut ? __fadd_rn(npz, __fmul_rn(ddz, L)) : nlz;
    s[7] = taut ? nlvx - rad * ddx : nlvx;
    s[8] = taut ? nlvz - rad * ddz : nlvz;
    const float lpn2 = s[5] * s[5] + s[6] * s[6];
    const float lvn2 = s[7] * s[7] + s[8] * s[8];
    done = (lpn2 > c.pos_lim2) || (lvn2 > c.vel_lim2);
    counted = taut;
    return done ? 1.0f : -sqrtf(npx * npx + npz * npz);
  }
};

// quadrotor3d-slungload-v0: _slung3d_step_tiles (pallas_slungload.py:76-192),
// position-first Euler, the quaternion update of quadrotor3d (Q4), on
// env_kinds.cuh's struct.
struct Slung3dLoop : reinmav::Slung3dEnv {
  struct Consts : reinmav::Slung3dEnv::Consts {
    float inv_m, pos_lim2, vel_lim2;
  };
  __device__ static Consts consts(const Params& p) {
    return {reinmav::Slung3dEnv::consts(p), __frcp_rn(p.mass), p.pos_limit * p.pos_limit,
            p.vel_limit * p.vel_limit};
  }
  // counted: the tether was taut at the start of the step.
  __device__ static float step(float (&s)[kD], const float (&act)[kA], const Params& p,
                               const Consts& c, bool& done, bool& counted) {
    const float px = s[0], py = s[1], pz = s[2];
    const float qw = s[3], qx = s[4], qy = s[5], qz = s[6];
    const float vx = s[7], vy = s[8], vz = s[9];
    const float lx = s[10], ly = s[11], lz = s[12], lvx = s[13], lvy = s[14], lvz = s[15];
    const float thrust = act[0], wx = act[1], wy = act[2], wz = act[3];
    const float dt = p.dt, g = p.gravity, L = p.tether_length, m = p.mass;
    const BodyZ bz = reinmav::body_z(s);

    const float tx = lx - px, ty = ly - py, tz = lz - pz;
    const float tn = sqrtf(__fadd_rn(__fadd_rn(__fmul_rn(tx, tx), __fmul_rn(ty, ty)),
                                     __fmul_rn(tz, tz)));  // the knife edge
    const float inv = reinmav::safe_inv(tn);
    const float ux = tx * inv, uy = ty * inv, uz = tz * inv;
    const bool taut = tn >= L;

    // The load: the taut branch's acceleration, free fall when slack.
    const float sc = m * L * (lvx * lvx + lvy * lvy + lvz * lvz);
    const float proj =
        ux * (thrust * bz.x - sc) + uy * (thrust * bz.y - sc) + uz * (thrust * bz.z - sc);
    const float lax_t = proj * ux * c.inv_mml;
    const float lay_t = proj * uy * c.inv_mml;
    const float laz_t = proj * uz * c.inv_mml + g;
    const float lax = taut ? lax_t : 0.0f;
    const float lay = taut ? lay_t : 0.0f;
    const float laz = taut ? laz_t : g;
    const float nlx = lx + lvx * dt + 0.5f * lax * dt * dt;  // position FIRST (old velocity)
    const float nly = ly + lvy * dt + 0.5f * lay * dt * dt;
    const float nlz = lz + lvz * dt + 0.5f * laz * dt * dt;
    const float nlvx = lvx + lax * dt, nlvy = lvy + lay * dt, nlvz = lvz + laz * dt;

    // The quad: thrust and the tether's pull, none when slack.
    const float dzg = laz_t - g;
    const float tmag = p.load_mass * sqrtf(lax_t * lax_t + lay_t * lay_t + dzg * dzg);
    const float fx = taut ? tmag * ux * c.inv_m : 0.0f;
    const float fy = taut ? tmag * uy * c.inv_m : 0.0f;
    const float fz = taut ? tmag * uz * c.inv_m : 0.0f;
    const float tm = thrust * c.inv_m;
    const float ax = tm * bz.x + fx;
    const float ay = tm * bz.y + fy;
    const float az = tm * bz.z + g + fz;
    const float npx = px + vx * dt + 0.5f * ax * dt * dt;
    const float npy = py + vy * dt + 0.5f * ay * dt * dt;
    const float npz = pz + vz * dt + 0.5f * az * dt * dt;
    const float nvx = vx + ax * dt, nvy = vy + ay * dt, nvz = vz + az * dt;

    // The kinematic projection onto the tether sphere, kept when taut.
    const float dx = nlx - npx, dy = nly - npy, dz = nlz - npz;
    const float dinv = reinmav::safe_inv(sqrtf(
        __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz))));
    const float ddx = dx * dinv, ddy = dy * dinv, ddz = dz * dinv;
    const float rad = (nlvx - nvx) * ddx + (nlvy - nvy) * ddy + (nlvz - nvz) * ddz;

    const float hw = qw * bz.inv_qn, hx = qx * bz.inv_qn, hy = qy * bz.inv_qn, hz = qz * bz.inv_qn;
    s[3] = qw + c.half_dt * (-hx * wx - hy * wy - hz * wz);
    s[4] = qx + c.half_dt * (hw * wx + hy * wz - hz * wy);
    s[5] = qy + c.half_dt * (hw * wy - hx * wz + hz * wx);
    s[6] = qz + c.half_dt * (hw * wz + hx * wy - hy * wx);
    s[0] = npx; s[1] = npy; s[2] = npz;
    s[7] = nvx; s[8] = nvy; s[9] = nvz;
    s[10] = taut ? __fadd_rn(npx, __fmul_rn(ddx, L)) : nlx;
    s[11] = taut ? __fadd_rn(npy, __fmul_rn(ddy, L)) : nly;
    s[12] = taut ? __fadd_rn(npz, __fmul_rn(ddz, L)) : nlz;
    s[13] = taut ? nlvx - rad * ddx : nlvx;
    s[14] = taut ? nlvy - rad * ddy : nlvy;
    s[15] = taut ? nlvz - rad * ddz : nlvz;
    const float lpn2 = s[10] * s[10] + s[11] * s[11] + s[12] * s[12];
    const float vn2 = nvx * nvx + nvy * nvy + nvz * nvz;
    done = (lpn2 > c.pos_lim2) || (vn2 > c.vel_lim2);
    counted = taut;
    return done ? 1.0f : -sqrtf(lpn2);
  }
};

template <class Loop, bool kCount>
__global__ void __launch_bounds__(kThreads)
closed_loop_kernel(const float* __restrict__ s_in, float* __restrict__ s_out,
                   float* __restrict__ reward_out, int* __restrict__ counts, int64_t batch,
                   int horizon, uint32_t seed, int autoreset, typename Loop::Params p) {
  constexpr int kD = Loop::kD;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= batch) return;  // ragged tail
  const typename Loop::Consts c = Loop::consts(p);
  const uint32_t env = static_cast<uint32_t>(i);

  float s[kD];
#pragma unroll
  for (int d = 0; d < kD; ++d) s[d] = s_in[d * batch + i];
  float reward_sum = 0.0f;
  int count = 0;

  for (int t = 0; t < horizon; ++t) {
    float act[Loop::kA];
    Loop::control(s, p, c, act);
    bool done, counted;
    reward_sum += Loop::step(s, act, p, c, done, counted);
    if (kCount) count += counted ? 1 : 0;
    if (autoreset && done) reinmav::reset_uniform(s, env, static_cast<uint32_t>(t), seed, 0u);
  }

#pragma unroll
  for (int d = 0; d < kD; ++d) s_out[d * batch + i] = s[d];
  reward_out[i] = reward_sum;
  if (kCount) counts[i] = count;
}

template <class Loop>
cudaError_t launch(const float* s_in, float* s_out, float* reward_out, int* counts,
                   int64_t batch, int horizon, uint32_t seed, int autoreset,
                   const float* params_host, int n_params, cudaStream_t stream) {
  if (n_params != Loop::kParams || batch <= 0) return cudaErrorInvalidValue;
  const auto blocks = static_cast<unsigned int>((batch + kThreads - 1) / kThreads);
  const typename Loop::Params p = Loop::params(params_host);
  if (counts != nullptr) {
    closed_loop_kernel<Loop, true><<<blocks, kThreads, 0, stream>>>(
        s_in, s_out, reward_out, counts, batch, horizon, seed, autoreset, p);
  } else {
    closed_loop_kernel<Loop, false><<<blocks, kThreads, 0, stream>>>(
        s_in, s_out, reward_out, nullptr, batch, horizon, seed, autoreset, p);
  }
  return cudaGetLastError();
}

}  // namespace

// C interface, bound with ctypes (reinmav_tpu_torch/_build.py).  Launches on
// the given stream, does not synchronise, and returns a CUDA error code.
// env_kind: 2 quadrotor2d-v0 (params_host: the 11 floats of
// quad2d_params_vec, states (5, B)), 3 quadrotor2d-slungload-v0 (12 floats,
// (9, B)), 4 quadrotor3d-slungload-v0 (13 floats, (16, B)); any other kind,
// or another number of params, is refused with cudaErrorInvalidValue and
// nothing runs.  counts: null, or B int32 that receive each env's count
// (taut env-steps of the slung kinds, done env-steps of quad2d).
extern "C" int closed_loop_rollout_launch(int env_kind, const void* states_in, void* states_out,
                                          void* reward_out, void* counts, long long batch,
                                          int horizon, unsigned int seed, int autoreset,
                                          const void* params_host, int n_params, void* stream) {
  const auto* s_in = static_cast<const float*>(states_in);
  auto* s_out = static_cast<float*>(states_out);
  auto* r_out = static_cast<float*>(reward_out);
  auto* n_out = static_cast<int*>(counts);
  const auto* h = static_cast<const float*>(params_host);
  const auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (env_kind) {
    case Quad2dLoop::kKind:
      err = launch<Quad2dLoop>(s_in, s_out, r_out, n_out, batch, horizon, seed, autoreset, h,
                               n_params, st);
      break;
    case Slung2dLoop::kKind:
      err = launch<Slung2dLoop>(s_in, s_out, r_out, n_out, batch, horizon, seed, autoreset, h,
                                n_params, st);
      break;
    case Slung3dLoop::kKind:
      err = launch<Slung3dLoop>(s_in, s_out, r_out, n_out, batch, horizon, seed, autoreset, h,
                                n_params, st);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
