// K2/K6's bf16 instance (compute_dtype "bfloat16"): the fused PPO rollout
// of ppo_rollout.cu with the actor-critic's products on the tensor cores
// (mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32, mma_bf16.cuh).
// The same function as the float32 kernel in the TPU kernel's bf16 mode
// (reinmav_tpu/ops/pallas_ppo_rollout.py::ppo_rollout_pallas :703, its _mm
// :102-105 with cd bf16 :738, the products :622-624): every operand of a
// product rounded to bf16, the exact products summed in float32.  Its plain
// twin is ops/ppo_rollout.py::ppo_rollout_reference with compute_dtype
// "bfloat16" (_towers_bf16).
//
// What bounds it: the products are 2 (64 D + 2 64 64 + 64 (A + 1)) = 19.6k
// operations an env-step at D = 10, 0.02 us a thousand env-steps at 989
// TFLOP/s; the 256 tanhf an env-step (two layers of two towers of 64
// units, each an ex2 and a reciprocal on the SFU) take 268 M SFU
// operations a launch at 32,768 x 32, about 0.15 ms at 16 a clock an SM.
// So the elementwise work sets the pace, not the products.  The float32
// body ran the products as FP32 FMAs, one env a thread, about 21k
// instructions an env-step on 2 warps a scheduler.
//
// Design.  A warp takes 16 envs, one m16 row block of every product; a CTA
// of 8 warps takes 128 envs, the float32 kernel's CTA of envs (the moment
// partials keep its layout), and two CTAs fit an SM (89 KB of shared
// memory each; __launch_bounds__ caps the registers at 128), so 32,768
// envs give 16 warps an SM, 4 a scheduler, against the float32 kernel's 2.
// Lane r < 16 holds env r's state, running return and 2D + 3 moment sums
// in registers for the whole horizon and runs the obs normalisation, the
// noise, the env step and the reset as the float32 kernel does, with its
// arithmetic; the products and their tanhf spread over all 32 lanes.  Per
// env-step and tower:
//   L1  h1 = tanh(x W1 + b1)   16 x 64 x 16 (D padded to 16 with zeros)
//   L2  h2 = tanh(h1 W2 + b2)  16 x 64 x 64
// The obs rows reach the A fragment through shared memory (each env lane
// writes its bf16 row); each accumulator starts from its bias; L1's
// accumulators, through tanhf and packed to bf16, are L2's A fragments in
// registers; the weights sit in shared memory as bf16 (W1, W2 row (in,
// out), read with ldmatrix.trans).  The heads (A means in tower 0, the
// value in tower 1) are FP32 FMAs in the twin's order, from the bias over
// the units in order (_towers_bf16), on the bf16 h2 rows that each warp
// stores: lane r < 16 the means of env r, lane 16 + r its value; given
// the twin's bf16 h2 they are the twin's bit for bit.
//
// Numerics.  The tensor cores sum in their own order, so a sum may differ
// from the twin's in its last bits, and an h that lies near the midpoint
// between its two bf16 neighbours could round the other way: a whole bf16
// step (2^-8 relative) on one hidden unit, which moves the env's mean and
// value.  So every h within kTie of a midpoint is recomputed in the twin's
// order, the warp's flagged h's handed out one a lane (tc::for_each_
// flagged; K3/K4's bf16 body has each lane recompute its own, and the
// warp waits for the lane with the most): h1 from the bias over the obs
// dims, h2 from the bias adding the partial
// sum of each run of 4 units, ((p0 + p1) + p2) + p3 (_towers_bf16).  Then
// the bf16 h1 and h2, and with them the heads, are the twin's, as long as
// the tensor cores' h lies within kTie of the twin's.  The probe instance
// (kProbe, launched by ppo_rollout_bf16_probe_launch, never by a training
// path) recomputes every h in the twin's order and counts the h's
// recomputed, the h's whose bf16 rounding would differ from the twin's
// without being recomputed (misses: 0 when kTie holds), and the largest
// |h - twin's h| / kTie of each layer.
//
// No atomics on the main path: the moment sums reduce in a fixed order,
// within each warp by shuffles, then the warps in index order, as the
// float32 kernel; a rerun is bitwise equal.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "actor_critic.cuh"
#include "env_kinds.cuh"
#include "mma_bf16.cuh"

namespace reinmav {
namespace ppo_rollout_bf16 {

namespace ac = reinmav::ac;
using tc::bf16;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 16;                 // envs a warp: one m16 row block
constexpr int kCtaEnvs = kWarps * kRows;  // 128
constexpr int kH = ac::H;
constexpr int kWP = kH + 8;  // weight and activation rows (bf16), padded so that the 8 rows
                             // of an ldmatrix fall on 8 distinct 4-bank groups
constexpr int kXP = 16 + 8;  // obs rows (bf16): D padded to 16, then 8
// How close an h may lie to the midpoint between its two bf16 neighbours
// before it is recomputed in the twin's order: chosen above the difference
// between the tensor cores' sum and the twin's FMA chain (K <= 64 products
// of bf16 operands, each exact in float32, and the bias) that the probe
// measured, not a bound on it: that difference grows with the sum of the
// products' magnitudes, which a cancelling sum makes large beside |h|.
constexpr float kTie = 1.0f / (1 << 20);

template <int kD, int kA>
struct Smem {
  static_assert(kD <= 16, "L1 takes one k16 step");
  static constexpr int kStats = 2 * kD + 3;
  static constexpr int kConsts = 2 * kD + kA + 3;
  alignas(16) bf16 w1[2][16][kWP];  // (tower, in, out); rows D..15 zero
  alignas(16) bf16 w2[2][kH][kWP];  // (tower, in, out)
  alignas(16) bf16 x[kWarps][kRows][kXP];  // each warp's bf16 obs rows; columns D..15 zero
  alignas(16) bf16 h1[kWarps][kRows][kWP];
  alignas(16) bf16 h2[kWarps][2][kRows][kWP];  // (warp, tower, env, unit)
  alignas(16) float wpi[kH][kA];  // bf16 values
  float wvf[kH];
  float b1[2][kH];
  float b2[2][kH];
  float bo[kA + 1];
  float cst[kConsts];
  float red[kWarps][kStats];
  uint32_t fix[kWarps][32];  // each warp's list of the outputs it recomputes
};

// A 16 x 64 block of a layer's outputs (eight m16n8 accumulators, tanh
// applied) packed to bf16 into the A fragments `fa` and stored to `rows`;
// returns the lane's slots (4 nt + i) that lie within kTie of a midpoint.
__device__ __forceinline__ uint32_t pack_rows(const float (&c)[8][4], uint32_t (&fa)[4][4],
                                              bf16 (*rows)[kWP], int lane) {
  const int g = lane >> 2, q = lane & 3;
  uint32_t near = 0;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float(&t)[4] = c[2 * kk + h];
      fa[kk][2 * h] = tc::pack(t[0], t[1]);
      fa[kk][2 * h + 1] = tc::pack(t[2], t[3]);
      tc::st_pair(&rows[g][8 * (2 * kk + h) + 2 * q], fa[kk][2 * h]);
      tc::st_pair(&rows[g + 8][8 * (2 * kk + h) + 2 * q], fa[kk][2 * h + 1]);
    }
  }
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      near |= static_cast<uint32_t>(tc::midpoint_distance(c[nt][i]) <= kTie) << (4 * nt + i);
    }
  }
  return near;
}

// The outputs of the warp's slots `near` recomputed by unit(row, column)
// and stored, rounded to bf16, into `rows`, one a lane a pass
// (tc::for_each_flagged).  Returns whether the warp had any.
template <class Unit>
__device__ __forceinline__ bool fix_midpoints(uint32_t near, bf16 (*rows)[kWP], uint32_t* list,
                                              int lane, Unit&& unit) {
  return tc::for_each_flagged(near, list, lane, [&](int owner, int slot) {
           const int row = tc::acc_row(owner, slot & 3);
           const int col = 8 * (slot >> 2) + tc::acc_col(owner, slot & 3);
           rows[row][col] = __float2bfloat16_rn(unit(row, col));
         }) > 0;
}

// The probe's check of one layer: every output of a valid row (`valid`, a
// row mask of the 16) recomputed in the twin's order, the misses counted,
// the largest difference over kTie kept; `near` the slots recomputed.
template <class Unit>
__device__ __forceinline__ void probe_layer(const float (&c)[8][4], uint32_t near, uint32_t valid,
                                            int lane, Unit&& unit, unsigned& redone,
                                            unsigned& missed, float& worst) {
#pragma unroll 1  // one copy of unit's code: the probe's build time, not its speed
  for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = tc::acc_row(lane, i), col = 8 * nt + tc::acc_col(lane, i);
      if (!((valid >> row) & 1u)) continue;
      const float twin = unit(row, col);
      worst = fmaxf(worst, fabsf(c[nt][i] - twin) * (1.0f / kTie));
      const bool fixed = (near >> (4 * nt + i)) & 1u;
      redone += fixed;
      missed += !fixed && tc::round_bf16(twin) != tc::round_bf16(c[nt][i]);
    }
  }
}

// The outputs of a launch (ppo_rollout.cu's RolloutOut without the stats
// and counts): (T, D, B) obs, (T, A, B) action, (T, B) log_prob, value,
// reward, done, (D, B) final states, (B,) returns, (CTAs, 2D + 3) partials.
struct Out {
  float* obs;
  float* action;
  float* log_prob;
  float* value;
  float* reward;
  bool* done;
  float* final_states;
  float* returns;
  float* partials;
};

// Launches the bf16 instance of kind `env_kind` (env_kinds.cuh) for the
// normalisers' switches, or with `probe` (both switches on) its probe, on
// `st`; ceil(batch / kCtaEnvs) CTAs.  Returns a CUDA error code; ppo_
// rollout.cu's entry points call it and then reduce the partials.
// Defined in ppo_rollout_bf16.cu.
cudaError_t launch(int env_kind, bool norm_obs, bool norm_rew, const float* s_in,
                   const float* ret_in, const float* net, const float* consts, int64_t batch,
                   int horizon, uint32_t seed, uint32_t env_base, const float* params_host,
                   const Out& o, unsigned* probe, cudaStream_t st);

template <class Env, bool kNormObs, bool kNormRew, bool kProbe>
__device__ __forceinline__ void rollout(const float* __restrict__ s_in,
                                        const float* __restrict__ ret_in,
                                        const float* __restrict__ net,
                                        const float* __restrict__ consts, int64_t batch,
                                        int horizon, uint32_t seed, uint32_t env_base,
                                        const typename Env::Params& p, const Out& o,
                                        unsigned* __restrict__ probe) {
  constexpr int kD = Env::kD, kA = Env::kA;
  using Sm = Smem<kD, kA>;
  using L = ac::Layout<kD, kA>;
  constexpr int kStats = Sm::kStats;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Sm& sm = *reinterpret_cast<Sm*>(smem_raw);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // The weights, rounded to bf16 once, when staged (the biases stay
  // float32); the obs rows zeroed (their columns D..15 stay zero).
  for (int idx = tid; idx < 16 * kH; idx += kThreads) {
    const int d = idx / kH, j = idx % kH;
    for (int tw = 0; tw < 2; ++tw) {
      sm.w1[tw][d][j] =
          __float2bfloat16_rn(d < kD ? net[L::tower_base(tw) + L::kW1 + d * kH + j] : 0.0f);
    }
  }
  for (int idx = tid; idx < kH * kH; idx += kThreads) {
    const int k = idx / kH, j = idx % kH;
    for (int tw = 0; tw < 2; ++tw) {
      sm.w2[tw][k][j] = __float2bfloat16_rn(net[L::tower_base(tw) + L::kW2 + idx]);
    }
  }
  for (int j = tid; j < kH; j += kThreads) {
    for (int tw = 0; tw < 2; ++tw) {
      sm.b1[tw][j] = net[L::tower_base(tw) + L::kB1 + j];
      sm.b2[tw][j] = net[L::tower_base(tw) + L::kB2 + j];
    }
    for (int a = 0; a < kA; ++a) sm.wpi[j][a] = tc::round_bf16(net[L::kPiOutW + j * kA + a]);
    sm.wvf[j] = tc::round_bf16(net[L::kVfOutW + j]);
  }
  if (tid < kA) sm.bo[tid] = net[L::kPiOutB + tid];
  if (tid == kA) sm.bo[kA] = net[L::kVfOutB];
  for (int c = tid; c < Sm::kConsts; c += kThreads) sm.cst[c] = consts[c];
  for (int idx = tid; idx < kWarps * kRows * kXP; idx += kThreads) {
    (&sm.x[0][0][0])[idx] = __float2bfloat16_rn(0.0f);
  }
  __syncthreads();

  const int r = lane & (kRows - 1);  // the env of lane r and lane 16 + r
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kCtaEnvs + warp * kRows;
  const int64_t i = base + r;
  const bool env_lane = lane < kRows;
  const bool valid = env_lane && i < batch;
  // Rows of the warp's block that hold an env of the batch (the probe's).
  const int64_t left = batch - base;
  const uint32_t valid_rows = left >= kRows ? 0xffffu : left > 0 ? (1u << left) - 1u : 0u;
  const float* obs_mean = sm.cst;
  const float* obs_invstd = sm.cst + kD;
  const float* stdv = sm.cst + 2 * kD;
  const float ls_sum = sm.cst[2 * kD + kA];
  const float inv_ret_std = sm.cst[2 * kD + kA + 1];
  const float gamma = sm.cst[2 * kD + kA + 2];
  const typename Env::Consts env_consts = Env::consts(p);
  const uint32_t env = static_cast<uint32_t>(i) + env_base;
  bf16(*xr)[kXP] = sm.x[warp];
  bf16(*h1r)[kWP] = sm.h1[warp];

  float acc[kStats];
#pragma unroll
  for (int c = 0; c < kStats; ++c) acc[c] = 0.0f;
  float s[kD];
  float ret = 0.0f;
#pragma unroll
  for (int d = 0; d < kD; ++d) s[d] = valid ? s_in[d * batch + i] : 0.0f;
  if (valid) ret = ret_in[i];
  unsigned redone1 = 0, redone2 = 0, missed1 = 0, missed2 = 0;
  float worst1 = 0.0f, worst2 = 0.0f;

  for (int t = 0; t < horizon; ++t) {
    const int64_t row = static_cast<int64_t>(t) * batch;
    // Raw-obs moments and normalisation (collect_rollout :203-213); the
    // float32 normalised obs to the trajectory, its bf16 row to the warp's
    // obs rows.
    if (valid) {
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
#pragma unroll
      for (int d = 0; d < kD; d += 2) {
        tc::st_pair(&xr[r][d], tc::pack(x[d], d + 1 < kD ? x[d + 1] : 0.0f));
      }
    }
    __syncwarp();
    uint32_t xa[4];
    tc::ldsm4(xa, &xr[tc::row_a(lane)][tc::col_a(lane)]);

    // The actor-critic, one tower at a time, the warp's 16 envs together.
#pragma unroll 1
    for (int tw = 0; tw < 2; ++tw) {
      float c[8][4];
      uint32_t fa[4][4];
      const int q2 = 2 * (lane & 3);
      // L1, from the bias.
#pragma unroll
      for (int pp = 0; pp < 4; ++pp) {
        uint32_t b[4];
        tc::ldsm4t(b, &sm.w1[tw][tc::row_a(lane)][16 * pp + tc::col_a(lane)]);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float b0 = sm.b1[tw][16 * pp + 8 * h + q2], b1 = sm.b1[tw][16 * pp + 8 * h + q2 + 1];
          c[2 * pp + h][0] = b0, c[2 * pp + h][1] = b1, c[2 * pp + h][2] = b0, c[2 * pp + h][3] = b1;
        }
        tc::mma(c[2 * pp], xa, b[0], b[1]);
        tc::mma(c[2 * pp + 1], xa, b[2], b[3]);
      }
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
        for (int k = 0; k < 4; ++k) c[nt][k] = tanhf(c[nt][k]);
      }
      // The twin's h1: from the bias over the obs dims in order.
      auto l1_unit = [&](int rr, int col) {
        float z = sm.b1[tw][col];
#pragma unroll
        for (int d = 0; d < kD; ++d) z = fmaf(tc::to_float(xr[rr][d]), tc::to_float(sm.w1[tw][d][col]), z);
        return tanhf(z);
      };
      uint32_t near = pack_rows(c, fa, h1r, lane);
      if constexpr (kProbe) {
        __syncwarp();
        probe_layer(c, near, valid_rows, lane, l1_unit, redone1, missed1, worst1);
      }
      if (fix_midpoints(near, h1r, sm.fix[warp], lane, l1_unit)) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          tc::ldsm4(fa[kk], &h1r[tc::row_a(lane)][16 * kk + tc::col_a(lane)]);
        }
      }

      // L2, from the bias.
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const float b0 = sm.b2[tw][8 * nt + q2], b1 = sm.b2[tw][8 * nt + q2 + 1];
        c[nt][0] = b0, c[nt][1] = b1, c[nt][2] = b0, c[nt][3] = b1;
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int pp = 0; pp < 4; ++pp) {
          uint32_t b[4];
          tc::ldsm4t(b, &sm.w2[tw][16 * kk + tc::row_a(lane)][16 * pp + tc::col_a(lane)]);
          tc::mma(c[2 * pp], fa[kk], b[0], b[1]);
          tc::mma(c[2 * pp + 1], fa[kk], b[2], b[3]);
        }
      }
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
        for (int k = 0; k < 4; ++k) c[nt][k] = tanhf(c[nt][k]);
      }
      // The twin's h2: from the bias, adding each run of 4 units' partial
      // sum ((p0 + p1) + p2) + p3.
      auto l2_unit = [&](int rr, int col) {
        float z = sm.b2[tw][col];
#pragma unroll 4
        for (int k0 = 0; k0 < kH; k0 += 8) {
          const uint4 hv = *reinterpret_cast<const uint4*>(&h1r[rr][k0]);
          const uint32_t w[4] = {hv.x, hv.y, hv.z, hv.w};
#pragma unroll
          for (int run = 0; run < 2; ++run) {
            const int k = k0 + 4 * run;
            float part = tc::lo_half(w[2 * run]) * tc::to_float(sm.w2[tw][k][col]);
            part = fmaf(tc::hi_half(w[2 * run]), tc::to_float(sm.w2[tw][k + 1][col]), part);
            part = fmaf(tc::lo_half(w[2 * run + 1]), tc::to_float(sm.w2[tw][k + 2][col]), part);
            part = fmaf(tc::hi_half(w[2 * run + 1]), tc::to_float(sm.w2[tw][k + 3][col]), part);
            z = z + part;
          }
        }
        return tanhf(z);
      };
      bf16(*h2r)[kWP] = sm.h2[warp][tw];
      near = pack_rows(c, fa, h2r, lane);
      if constexpr (kProbe) {
        __syncwarp();
        probe_layer(c, near, valid_rows, lane, l2_unit, redone2, missed2, worst2);
      }
      fix_midpoints(near, h2r, sm.fix[warp], lane, l2_unit);
      __syncwarp();  // the rows' readers are done before the next tower writes them
    }

    // The heads in the twin's order, from the bias over the bf16 h2 units
    // in order: lane r the means of env r, lane 16 + r its value.
    float head[kA];
    if (env_lane) {
      const bf16* h = sm.h2[warp][0][r];
#pragma unroll
      for (int a = 0; a < kA; ++a) head[a] = sm.bo[a];
#pragma unroll 2
      for (int j0 = 0; j0 < kH; j0 += 8) {
        const uint4 hv = *reinterpret_cast<const uint4*>(h + j0);
        const uint32_t w[4] = {hv.x, hv.y, hv.z, hv.w};
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float hj = j & 1 ? tc::hi_half(w[j >> 1]) : tc::lo_half(w[j >> 1]);
#pragma unroll
          for (int a = 0; a < kA; ++a) head[a] = fmaf(hj, sm.wpi[j0 + j][a], head[a]);
        }
      }
    } else {
      const bf16* h = sm.h2[warp][1][r];
      head[0] = sm.bo[kA];
#pragma unroll 2
      for (int j0 = 0; j0 < kH; j0 += 8) {
        const uint4 hv = *reinterpret_cast<const uint4*>(h + j0);
        const uint32_t w[4] = {hv.x, hv.y, hv.z, hv.w};
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          head[0] = fmaf(j & 1 ? tc::hi_half(w[j >> 1]) : tc::lo_half(w[j >> 1]), sm.wvf[j0 + j],
                         head[0]);
        }
      }
    }
    const float value = __shfl_sync(0xffffffffu, head[0], (lane + kRows) & 31);

    if (valid) {
      // Gaussian action; logp from the rounded action (the float32 kernel's).
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
        act[a] = head[a] + stdv[a] * noise;
        const float zz = (act[a] - head[a]) * (1.0f / stdv[a]);
        z2 += zz * zz;
        o.action[(row * kA) + a * batch + i] = act[a];
      }
      o.log_prob[row + i] = -0.5f * z2 - ls_sum - 0.5f * kA * ac::kLog2Pi;
      o.value[row + i] = value;

      // Env step.
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
  }

  if (valid) {
#pragma unroll
    for (int d = 0; d < kD; ++d) o.final_states[d * batch + i] = s[d];
    o.returns[i] = ret;
  }

  // The CTA's moment sums in a fixed order: within each warp by shuffles
  // (lanes 16-31 add zeros), then the warps in index order.
#pragma unroll
  for (int c = 0; c < kStats; ++c) {
    float v = acc[c];
#pragma unroll
    for (int off = 16; off > 0; off /= 2) v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) sm.red[warp][c] = v;
  }
  __syncthreads();
  if (tid < kStats) {
    float v = sm.red[0][tid];
    for (int w = 1; w < kWarps; ++w) v += sm.red[w][tid];
    o.partials[static_cast<int64_t>(blockIdx.x) * kStats + tid] = v;
  }
  if constexpr (kProbe) {
    atomicAdd(probe + 0, redone1);
    atomicAdd(probe + 1, redone2);
    atomicAdd(probe + 2, missed1);
    atomicAdd(probe + 3, missed2);
    atomicMax(probe + 4, __float_as_uint(worst1));
    atomicMax(probe + 5, __float_as_uint(worst2));
  }
}

}  // namespace ppo_rollout_bf16
}  // namespace reinmav
