// K2 and K6: the fused PPO rollout of quadrotor3d-v0 (K2), of the hover task
// (MujocoQuadForce-v1, K6-hover) and of quadrotor2d-v0 and the two slung-load
// envs (K6-rest), written for NVIDIA Hopper (sm_90a).
//
// Replaces reinmav_tpu/ops/pallas_ppo_rollout.py::ppo_rollout_pallas (:703,
// pallas_call :771), every kind of its _ENVS table (:516): the grid step
// _kernel (:556-695) with the kind's step and reset rows (_quad3d_step_tiles
// :157, _hover_step_tiles :112-144, _quad2d_step_tiles :205,
// _slung2d_step_tiles :239, _slung3d_step_tiles :336), repeated over the
// whole horizon.  Per env and step: raw-obs moment sums, obs normalisation with
// clip +-10, the 2x64 tanh actor-critic, a Gaussian action with logp taken
// from the ROUNDED action (z = (a - mean) / std, :628-638), the env step,
// the return-scaled reward with clip +-10, the running discounted return,
// the reset of done envs, and the trajectory rows.  The kernel is a template
// on the env structs of env_kinds.cuh, which fix the state dim D and the
// action dim A: Quad3dEnv (D 10, A 4), HoverEnv (13, 4; two substeps of
// hover_common.cuh, the deterministic reset, no reset draws), Quad2dEnv (5,
// 2), Slung2dEnv (9, 2) and Slung3dEnv (16, 4) (slung_common.cuh); the
// U(-1, 1)^D resets draw from Philox stream 2.  Its plain PyTorch twin, with the same arithmetic and the
// same Philox draws, is reinmav_tpu_torch/ops/ppo_rollout.py::
// ppo_rollout_reference.
//
// What bounds it on the card: instruction issue.  One env-step is 2 * (D*128
// + 2*64*64 + 64*A + 64*1) FP32 operations of MLP (19.6k for quadrotor3d, D
// = 10; 20.4k for hover, D = 13; 17.8k to 20.8k for the others; the zero
// blocks of the fused layer are not computed), plus the env step (about 30
// for quadrotor3d, 2 x 257 for hover), against 4 * (D + A + 4) B of
// trajectory written, far on the compute side of the H100's roofline.  The
// source's sums (each float4 step of a unit a 4-product partial, added to
// the unit's sum) make a unit 80 instructions for 64 products, and tanhf 17
// more: about 21k instructions an env-step.  At 32,768 envs, 256 CTAs of 128
// threads leave 2 warps a scheduler, too few to hide the latency of one
// unit's chain of partial sums, tanhf and heads.  At D = 16 the 2D + 3
// moment sums, the state and the first hidden layer compete for the 255
// registers a thread can have.
//
// What the design does about it: one thread per env, the env state, the
// running return and the 2D + 3 moment sums in registers for the whole
// horizon; the weights (40-42 KB) in shared memory, read as broadcasts
// (every thread of a warp reads the same weight at the same time), the
// second layer's as float4 rows; the first hidden layer of one tower (64
// floats) in registers; the second computed kUnits units a pass, each
// unit's sum its own chain in the source's order (so the bits are those of
// one unit a pass), which gives the scheduler kUnits independent chains to
// interleave, and consumed into the heads in unit order as it is computed,
// so it is never stored.  Noise and resets come from
// Philox4x32-10 (quad3d_common.cuh) with key (seed, 0) and counter (env,
// step, draw, stream), env the thread's env index plus env_base (0 on one
// rank; a rank's first env of the global batch when the batch is split
// over ranks, so that each env draws what it draws in the one-rank run):
// stream 1 is the noise (two draws, Box-Muller cosine
// branch as _normal :90-95; action a takes word a of each draw, so an A = 2
// kind uses the first two words of the same two draws), stream 2 the
// U(-1, 1)^D resets (ceil(D / 4) draws).
// Each CTA reduces its moment sums in a fixed order, and a second launch
// adds the CTAs' partials in block order, so the result is bitwise
// repeatable.  Any B works; the tail is masked.  normalize_obs and
// normalize_rewards are template switches; a fourth, in instances the
// training paths never launch, counts each slung-load env's taut env-steps
// (the tether taut at the start of the step).
//
// compute_dtype "bfloat16" launches ppo_rollout_bf16_kernel, a body of its
// own with the products on the tensor cores (ppo_rollout_body_bf16.cuh,
// built in ppo_rollout_bf16.cu).

#include <cuda_runtime.h>
#include <stdint.h>

#include "actor_critic.cuh"
#include "env_kinds.cuh"
#include "ppo_rollout_body_bf16.cuh"

namespace {

namespace ac = reinmav::ac;
constexpr int kThreads = 128;
static_assert(reinmav::ppo_rollout_bf16::kCtaEnvs == kThreads,
              "the bf16 CTA takes the float32 CTA's envs: one row of partials a CTA");
constexpr int kH = ac::H;
// Hidden units of the second layer computed a pass: 4 on every kind but
// quadrotor2d-slungload-v0, whose main-path instance ran slower with 4 than
// with 1 on an H100, as it runs slower than its own instances without obs
// normalisation, for no count that the SASS shows (PERF.md); it keeps 1.
template <class Env>
constexpr int kUnitsOf = Env::kKind == reinmav::Slung2dEnv::kKind ? 1 : 4;

struct RolloutOut {
  float* obs;       // (T, D, B)
  float* action;    // (T, A, B)
  float* log_prob;  // (T, B)
  float* value;     // (T, B)
  float* reward;    // (T, B)
  bool* done;       // (T, B)
  float* final_states;  // (D, B)
  float* returns;       // (B,)
  float* partials;      // (gridDim.x, 2D + 3)
  float* stats_out;     // (2D + 3,)
  int* counts;          // (B,) taut env-steps, the counting instances only
};

template <class Env, bool kNormObs, bool kNormRew, bool kCount>
__global__ void __launch_bounds__(kThreads)
ppo_rollout_kernel(const float* __restrict__ s_in, const float* __restrict__ ret_in,
                   const float* __restrict__ net, const float* __restrict__ consts,
                   int64_t batch, int horizon, uint32_t seed, uint32_t env_base,
                   typename Env::Params p, RolloutOut o) {
  constexpr int kD = Env::kD, kA = Env::kA, kUnits = kUnitsOf<Env>;
  constexpr int kStats = 2 * kD + 3;  // obs sum (D), obs sq (D), ret sum, ret sq, raw reward sum
  constexpr int kConsts = 2 * kD + kA + 3;
  using L = ac::Layout<kD, kA>;
  __shared__ __align__(16) float w1t[2][kH][kD];  // (tower, out, in)
  __shared__ __align__(16) float b1[2][kH];
  __shared__ __align__(16) float w2t[2][kH][kH];  // (tower, out, in)
  __shared__ __align__(16) float b2[2][kH];
  __shared__ __align__(16) float wpi[kH][kA];
  __shared__ float wvf[kH];
  __shared__ float bo[kA + 1];
  __shared__ float cst[kConsts];
  __shared__ float red[kThreads / 32][kStats];

  for (int idx = threadIdx.x; idx < kH * kD; idx += kThreads) {
    const int j = idx / kD, d = idx % kD;
    for (int tw = 0; tw < 2; ++tw) {
      w1t[tw][j][d] = net[L::tower_base(tw) + L::kW1 + d * kH + j];
    }
  }
  for (int idx = threadIdx.x; idx < kH * kH; idx += kThreads) {
    const int j = idx / kH, k = idx % kH;
    for (int tw = 0; tw < 2; ++tw) {
      w2t[tw][j][k] = net[L::tower_base(tw) + L::kW2 + k * kH + j];
    }
  }
  for (int j = threadIdx.x; j < kH; j += kThreads) {
    for (int tw = 0; tw < 2; ++tw) {
      b1[tw][j] = net[L::tower_base(tw) + L::kB1 + j];
      b2[tw][j] = net[L::tower_base(tw) + L::kB2 + j];
    }
    for (int a = 0; a < kA; ++a) wpi[j][a] = net[L::kPiOutW + j * kA + a];
    wvf[j] = net[L::kVfOutW + j];
  }
  if (threadIdx.x < kA) bo[threadIdx.x] = net[L::kPiOutB + threadIdx.x];
  if (threadIdx.x == kA) bo[kA] = net[L::kVfOutB];
  for (int c = threadIdx.x; c < kConsts; c += kThreads) cst[c] = consts[c];
  __syncthreads();

  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const bool valid = i < batch;
  float acc[kStats];
#pragma unroll
  for (int c = 0; c < kStats; ++c) acc[c] = 0.0f;

  if (valid) {
    const float* obs_mean = cst;
    const float* obs_invstd = cst + kD;
    const float* stdv = cst + 2 * kD;
    const float ls_sum = cst[2 * kD + kA];
    const float inv_ret_std = cst[2 * kD + kA + 1];
    const float gamma = cst[2 * kD + kA + 2];
    const typename Env::Consts env_consts = Env::consts(p);
    const uint32_t env = static_cast<uint32_t>(i) + env_base;

    float s[kD];
#pragma unroll
    for (int d = 0; d < kD; ++d) s[d] = s_in[d * batch + i];
    float ret = ret_in[i];
    int count = 0;

    for (int t = 0; t < horizon; ++t) {
      const int64_t row = static_cast<int64_t>(t) * batch;
      // Raw-obs moments and normalisation (collect_rollout :203-213).
      float x[kD];
#pragma unroll
      for (int d = 0; d < kD; ++d) {
        if (kNormObs) {
          acc[d] += s[d];
          acc[kD + d] += s[d] * s[d];
          x[d] = fminf(fmaxf((s[d] - obs_mean[d]) * obs_invstd[d], -10.0f), 10.0f);
        } else {
          x[d] = s[d];
        }
        o.obs[(row * kD) + d * batch + i] = x[d];
      }

      // The actor-critic, one tower at a time (networks.apply_t).
      float mean[kA];
#pragma unroll
      for (int a = 0; a < kA; ++a) mean[a] = bo[a];
      float value = bo[kA];
#pragma unroll 1
      for (int tw = 0; tw < 2; ++tw) {
        float h1[kH];
#pragma unroll
        for (int k = 0; k < kH; ++k) {
          float z = b1[tw][k];
#pragma unroll
          for (int d = 0; d < kD; ++d) z += w1t[tw][k][d] * x[d];
          h1[k] = tanhf(z);
        }
        // kUnits hidden units a pass, each its own chain in its own order.
#pragma unroll 1
        for (int j0 = 0; j0 < kH; j0 += kUnits) {
          float z[kUnits];
#pragma unroll
          for (int u = 0; u < kUnits; ++u) z[u] = b2[tw][j0 + u];
#pragma unroll
          for (int q = 0; q < kH / 4; ++q) {
#pragma unroll
            for (int u = 0; u < kUnits; ++u) {
              const float4 v = reinterpret_cast<const float4*>(w2t[tw][j0 + u])[q];
              z[u] += v.x * h1[4 * q] + v.y * h1[4 * q + 1] + v.z * h1[4 * q + 2] +
                      v.w * h1[4 * q + 3];
            }
          }
#pragma unroll
          for (int u = 0; u < kUnits; ++u) {
            const float h2 = tanhf(z[u]);
            if (tw == 0) {
#pragma unroll
              for (int a = 0; a < kA; ++a) mean[a] += h2 * wpi[j0 + u][a];
            } else {
              value += h2 * wvf[j0 + u];
            }
          }
        }
      }

      // Gaussian action; logp from the rounded action.
      const uint4 ub = reinmav::philox4x32_10(make_uint4(env, t, 0u, 1u), seed, 0u);
      const uint4 vb = reinmav::philox4x32_10(make_uint4(env, t, 1u, 1u), seed, 0u);
      const uint32_t uw[4] = {ub.x, ub.y, ub.z, ub.w};
      const uint32_t vw[4] = {vb.x, vb.y, vb.z, vb.w};
      float act[kA];
      float z2 = 0.0f;
#pragma unroll
      for (int a = 0; a < kA; ++a) {
        const float u = reinmav::uniform01(uw[a]);
        const float v = reinmav::uniform01(vw[a]);
        const float noise = sqrtf(-2.0f * logf(1.0f - u)) * cosf(6.28318530717958648f * v);
        act[a] = mean[a] + stdv[a] * noise;
        const float zz = (act[a] - mean[a]) * (1.0f / stdv[a]);
        z2 += zz * zz;
        o.action[(row * kA) + a * batch + i] = act[a];
      }
      o.log_prob[row + i] = -0.5f * z2 - ls_sum - 0.5f * kA * ac::kLog2Pi;
      o.value[row + i] = value;

      // Env step.
      if constexpr (kCount) count += Env::taut(s, p) ? 1 : 0;
      bool done;
      const float raw = Env::step(s, act, p, env_consts, done);
      const float done_f = done ? 1.0f : 0.0f;
      float reward = raw;
      if (kNormRew) {  // VecNormalize-style return scale (collect_rollout :225-234)
        ret = ret * gamma + raw;
        acc[2 * kD] += ret;
        acc[2 * kD + 1] += ret * ret;
        reward = fminf(fmaxf(raw * inv_ret_std, -10.0f), 10.0f);
        ret = ret * (1.0f - done_f);
      }
      acc[2 * kD + 2] += raw;
      o.reward[row + i] = reward;
      o.done[row + i] = done;
      if (done) Env::reset(s, env, static_cast<uint32_t>(t), seed, 2u, p);
    }

#pragma unroll
    for (int d = 0; d < kD; ++d) o.final_states[d * batch + i] = s[d];
    o.returns[i] = ret;
    if constexpr (kCount) o.counts[i] = count;
  }

  // The CTA's moment sums in a fixed order: within each warp by shuffles,
  // then the warps in index order.
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int c = 0; c < kStats; ++c) {
    float v = acc[c];
#pragma unroll
    for (int off = 16; off > 0; off /= 2) v += __shfl_down_sync(0xFFFFFFFFu, v, off);
    if (lane == 0) red[warp][c] = v;
  }
  __syncthreads();
  if (threadIdx.x < kStats) {
    float v = red[0][threadIdx.x];
    for (int w = 1; w < kThreads / 32; ++w) v += red[w][threadIdx.x];
    o.partials[static_cast<int64_t>(blockIdx.x) * kStats + threadIdx.x] = v;
  }
}

// stats[c] = the CTAs' partials of component c, added in block order.
__global__ void ppo_rollout_stats_kernel(const float* __restrict__ partials, int blocks,
                                         int n_stats, float* __restrict__ stats) {
  for (int c = threadIdx.x; c < n_stats; c += blockDim.x) {
    float v = 0.0f;
    for (int b = 0; b < blocks; ++b) v += partials[static_cast<int64_t>(b) * n_stats + c];
    stats[c] = v;
  }
}

// The float32 instances without counts, for both normalisers' switches.
template <class Env>
void launch_norm(bool norm_obs, bool norm_rew, const float* s_in, const float* ret_in,
                 const float* net, const float* consts, int64_t batch, int horizon,
                 uint32_t seed, uint32_t env_base, const typename Env::Params& p,
                 const RolloutOut& o, unsigned int blocks, cudaStream_t st) {
  if (norm_obs && norm_rew) {
    ppo_rollout_kernel<Env, true, true, false><<<blocks, kThreads, 0, st>>>(
        s_in, ret_in, net, consts, batch, horizon, seed, env_base, p, o);
  } else if (norm_obs) {
    ppo_rollout_kernel<Env, true, false, false><<<blocks, kThreads, 0, st>>>(
        s_in, ret_in, net, consts, batch, horizon, seed, env_base, p, o);
  } else if (norm_rew) {
    ppo_rollout_kernel<Env, false, true, false><<<blocks, kThreads, 0, st>>>(
        s_in, ret_in, net, consts, batch, horizon, seed, env_base, p, o);
  } else {
    ppo_rollout_kernel<Env, false, false, false><<<blocks, kThreads, 0, st>>>(
        s_in, ret_in, net, consts, batch, horizon, seed, env_base, p, o);
  }
}

template <class Env>
cudaError_t launch_env(const float* s_in, const float* ret_in, const float* net,
                       const float* consts, int64_t batch, int horizon, uint32_t seed,
                       uint32_t env_base, bool norm_obs, bool norm_rew, bool bf16,
                       const float* params_host, int n_params, const RolloutOut& o,
                       unsigned* probe, unsigned int blocks, cudaStream_t st) {
  if (n_params != Env::kParams) return cudaErrorInvalidValue;
  const typename Env::Params p = Env::params(params_host);
  if (o.counts != nullptr) {
    // The counting instance: slung-load kinds, both normalisers on, float32.
    if constexpr (Env::kTether) {
      if (!(norm_obs && norm_rew) || bf16) return cudaErrorInvalidValue;
      ppo_rollout_kernel<Env, true, true, true><<<blocks, kThreads, 0, st>>>(
          s_in, ret_in, net, consts, batch, horizon, seed, env_base, p, o);
    } else {
      return cudaErrorInvalidValue;
    }
  } else if (bf16) {
    const reinmav::ppo_rollout_bf16::Out ob{o.obs,    o.action, o.log_prob,     o.value,
                                            o.reward, o.done,   o.final_states, o.returns,
                                            o.partials};
    const cudaError_t err = reinmav::ppo_rollout_bf16::launch(
        Env::kKind, norm_obs, norm_rew, s_in, ret_in, net, consts, batch, horizon, seed, env_base,
        params_host, ob, probe, st);
    if (err != cudaSuccess) return err;
  } else {
    launch_norm<Env>(norm_obs, norm_rew, s_in, ret_in, net, consts, batch, horizon, seed,
                     env_base, p, o, blocks, st);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  constexpr int kStats = 2 * Env::kD + 3;
  ppo_rollout_stats_kernel<<<1, 32, 0, st>>>(o.partials, static_cast<int>(blocks), kStats,
                                             o.stats_out);
  return cudaGetLastError();
}

// Both entry points below.
int launch(int env_kind, const void* states_in, const void* returns_in, const void* net,
           const void* consts, long long batch, int horizon, unsigned int seed,
           unsigned int env_base, int normalize_obs, int normalize_rewards, int bf16,
           const void* params_host, int n_params, void* obs, void* action, void* log_prob,
           void* value, void* reward, void* done, void* final_states, void* returns_out,
           void* partials, void* stats, void* counts, void* probe, void* stream) {
  const RolloutOut o{static_cast<float*>(obs),          static_cast<float*>(action),
                     static_cast<float*>(log_prob),     static_cast<float*>(value),
                     static_cast<float*>(reward),       static_cast<bool*>(done),
                     static_cast<float*>(final_states), static_cast<float*>(returns_out),
                     static_cast<float*>(partials),     static_cast<float*>(stats),
                     static_cast<int*>(counts)};
  const auto blocks = static_cast<unsigned int>((batch + kThreads - 1) / kThreads);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* s_in = static_cast<const float*>(states_in);
  const auto* r_in = static_cast<const float*>(returns_in);
  const auto* w = static_cast<const float*>(net);
  const auto* c = static_cast<const float*>(consts);
  const auto* h = static_cast<const float*>(params_host);
  const cudaError_t err = reinmav::with_env_kind(env_kind, [&](auto env) {
    return launch_env<decltype(env)>(s_in, r_in, w, c, batch, horizon, seed, env_base,
                                     normalize_obs, normalize_rewards, bf16 != 0, h, n_params, o,
                                     static_cast<unsigned*>(probe), blocks, st);
  });
  return static_cast<int>(err);
}

}  // namespace

// C interface, bound with ctypes (reinmav_tpu_torch/_build.py).  Launches on
// the given stream, does not synchronise, and returns a CUDA error code.
// env_kind: a kind id of env_kinds.cuh (0 quadrotor3d-v0, 1
// MujocoQuadForce-v1, 2 quadrotor2d-v0, 3 quadrotor2d-slungload-v0, 4
// quadrotor3d-slungload-v0), params_host the floats of its params vector
// (ops/ppo_rollout.py::ENVS), states (D, B); any other kind, or another
// number of params, is refused with cudaErrorInvalidValue and nothing runs.
// `partials` is scratch of (ceil(batch / 128), 2D + 3) floats.  counts:
// null (the main path), or B int32 that receive each env's taut env-steps
// (the slung-load kinds with both normalisers on; any other call with
// counts is refused with cudaErrorInvalidValue).  bf16 nonzero: the bf16
// instance (no counts).  env_base: added to each env's index in the Philox
// counters (see above); 0 gives the draws of every earlier build.
extern "C" int ppo_rollout_launch(int env_kind, const void* states_in, const void* returns_in,
                                  const void* net, const void* consts, long long batch,
                                  int horizon, unsigned int seed, unsigned int env_base,
                                  int normalize_obs,
                                  int normalize_rewards, int bf16, const void* params_host,
                                  int n_params,
                                  void* obs, void* action, void* log_prob, void* value,
                                  void* reward, void* done, void* final_states, void* returns_out,
                                  void* partials, void* stats, void* counts, void* stream) {
  return launch(env_kind, states_in, returns_in, net, consts, batch, horizon, seed, env_base,
                normalize_obs, normalize_rewards, bf16, params_host, n_params, obs, action,
                log_prob, value, reward, done, final_states, returns_out, partials, stats, counts,
                nullptr, stream);
}

// The bf16 instance's probe (ppo_rollout_body_bf16.cuh; no training path
// launches it): ppo_rollout_launch's arguments with both normalisers on,
// bf16, no counts, and `probe`, 6 uint32 on the device, zeroed by the
// caller, to which the launch adds the h1 and h2 recomputed in the twin's
// order, the h1 and h2 misses, and takes the largest |h - twin's h| /
// kTie of each layer (float bits).  Its outputs are the bf16 instance's.
extern "C" int ppo_rollout_bf16_probe_launch(int env_kind, const void* states_in,
                                             const void* returns_in, const void* net,
                                             const void* consts, long long batch, int horizon,
                                             unsigned int seed, unsigned int env_base,
                                             const void* params_host, int n_params, void* obs,
                                             void* action, void* log_prob, void* value,
                                             void* reward, void* done, void* final_states,
                                             void* returns_out, void* partials, void* stats,
                                             void* probe, void* stream) {
  if (probe == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return launch(env_kind, states_in, returns_in, net, consts, batch, horizon, seed, env_base, 1,
                1, 1, params_host, n_params, obs, action, log_prob, value, reward, done,
                final_states, returns_out, partials, stats, nullptr, probe, stream);
}
