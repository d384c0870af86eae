// The per-CTA device body of the PPO loss forward and hand-derived backward
// over the 2x64 tanh actor-critic, shared by K3 (ppo_loss.cu, one minibatch
// per launch) and K4 (ppo_update.cu, the whole update in one launch); a
// template on the obs dim D and the action dim A, built for the (D, A)
// pairs of with_kernel_dims.
//
// The body is reinmav_tpu/ops/pallas_ppo.py::_tile_loss_grads (:71-173):
// the clipped or adaptive-KL surrogate, value clipping, JAX's tie
// conventions for minimum / maximum (sel1/sel2/tie :121-127, vs1/vs2/vtie
// :136-141), the log-std gradient, and the metric sums [pg, v, kl,
// clipfrac].  It writes raw SUMS over the CTA's share of the minibatch, in
// the flat parameter layout (actor_critic.cuh), then the 4 metric sums.
//
// Design (see ppo_loss.cu for the bound): a CTA of 256 threads takes 128
// samples at a time; thread (tower, s) runs sample s through one tower, so
// a warp's threads read the same weight at once (broadcast).  Activations
// stay in shared memory, in rows of 129 floats (padded, so that the
// per-sample column accesses and the row reads of the weight-gradient
// phases hit distinct banks).  The weight gradients are outer products
// summed over samples: each thread owns a fixed set of gradient entries
// (32 of dW2, 5 of dW1, ...) in registers for the CTA's whole share of the
// minibatch; the D rows of dW1 are split between the towers' threads, the
// first ceil(D / 2) rows to tower 0's and the rest to tower 1's (5 + 5 at D
// = 10, 7 + 6 at D = 13, 8 + 8 at D = 16).  The gather: minibatch sample q
// reads column perm[q / tile] * tile + q % tile of the full (R, n) batch, so
// the minibatch is never stored.  Shared memory at D = 10, A = 4: 40 KB of
// weights and 143 KB of activations; each obs dim adds about 1 KB (186 KB
// at D = 16).  The head-gradient phase gives thread tid the entry
// dW_pi[tid / A][tid % A]: all 256 threads at A = 4, the first 128 at A = 2.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "actor_critic.cuh"

namespace reinmav {
namespace ppo_loss {

namespace ac = reinmav::ac;

constexpr int kH = ac::H;
constexpr int kS = 128;       // samples per sub-block
constexpr int kSP = kS + 1;   // padded row length
constexpr int kThreads = 2 * kS;

// The raw sums a CTA writes: the flat gradient, then the 4 metric sums.
template <int kD, int kA>
__host__ __device__ constexpr int out_size() {
  return ac::Layout<kD, kA>::kNetSize + 4;
}

// f(integral_constant<D>, integral_constant<A>) for the (obs, action) dims
// the kernels are built for: (10, 4) quadrotor3d-v0, (13, 4) the tpuquad
// family, (5, 2) quadrotor2d-v0, (9, 2) quadrotor2d-slungload-v0, (16, 4)
// quadrotor3d-slungload-v0 (ops/ppo_loss.py::KERNEL_DIMS); `refused` for
// any other pair.
template <class R, class F>
R with_kernel_dims(int d, int a, R refused, F&& f) {
  using std::integral_constant;
  if (d == 10 && a == 4) return f(integral_constant<int, 10>{}, integral_constant<int, 4>{});
  if (d == 13 && a == 4) return f(integral_constant<int, 13>{}, integral_constant<int, 4>{});
  if (d == 5 && a == 2) return f(integral_constant<int, 5>{}, integral_constant<int, 2>{});
  if (d == 9 && a == 2) return f(integral_constant<int, 9>{}, integral_constant<int, 2>{});
  if (d == 16 && a == 4) return f(integral_constant<int, 16>{}, integral_constant<int, 4>{});
  return refused;
}

template <int kD, int kA>
struct Smem {
  static constexpr int kRed = kA + 4;  // per-sample dls (A) and metric terms (4)
  float w1t[2][kH][kD];
  float b1[2][kH];
  float w2t[2][kH][kH];  // (tower, out, in)
  float b2[2][kH];
  float wpi[kH][kA];
  float wvf[kH];
  float bo[kA + 1];
  float ls[kA];
  float h1[2 * kH][kSP];  // h1, then dpre1
  float h2[2 * kH][kSP];  // h2, then dpre2
  float x[kD][kSP];
  float dout[kA + 1][kSP];  // the heads' output, then its cotangent
  float red[kRed][kSP];
};

struct LossCfg {
  float clip_eps, value_clip_eps, value_coef;
};

// The weights of the flat vector `net` into shared memory.  The loads go
// through L2 (__ldcg), never the non-coherent read-only path: in K4 the
// same vector is rewritten by other CTAs between passes.  The caller
// synchronises the block before the body reads them.
template <int kD, int kA>
__device__ __forceinline__ void load_weights(Smem<kD, kA>& sm, const float* net) {
  using L = ac::Layout<kD, kA>;
  const int tid = threadIdx.x;
  for (int idx = tid; idx < kH * kD; idx += kThreads) {
    const int j = idx / kD, d = idx % kD;
    for (int t = 0; t < 2; ++t) sm.w1t[t][j][d] = __ldcg(net + L::tower_base(t) + L::kW1 + d * kH + j);
  }
  for (int idx = tid; idx < kH * kH; idx += kThreads) {
    const int j = idx / kH, k = idx % kH;
    for (int t = 0; t < 2; ++t) sm.w2t[t][j][k] = __ldcg(net + L::tower_base(t) + L::kW2 + k * kH + j);
  }
  for (int j = tid; j < kH; j += kThreads) {
    for (int t = 0; t < 2; ++t) {
      sm.b1[t][j] = __ldcg(net + L::tower_base(t) + L::kB1 + j);
      sm.b2[t][j] = __ldcg(net + L::tower_base(t) + L::kB2 + j);
    }
    for (int a = 0; a < kA; ++a) sm.wpi[j][a] = __ldcg(net + L::kPiOutW + j * kA + a);
    sm.wvf[j] = __ldcg(net + L::kVfOutW + j);
  }
  if (tid < kA) {
    sm.bo[tid] = __ldcg(net + L::kPiOutB + tid);
    sm.ls[tid] = __ldcg(net + L::kLogStd + tid);
  }
  if (tid == kA) sm.bo[kA] = __ldcg(net + L::kVfOutB);
}

// The loss gradient over the sub-blocks of 128 samples blockIdx.x,
// blockIdx.x + gridDim.x, ... of the minibatch of `mb` samples defined by
// `perm`, with the weights already in `sm`.  Writes the CTA's raw sums
// (out_size<kD, kA>() floats, each by exactly one thread) to `out`.  Ends after a block
// synchronisation of its last sub-block; the write of `out` is not
// followed by one.
template <int kD, int kA, bool kKl>
__device__ __forceinline__ void loss_body(Smem<kD, kA>& sm, const float* __restrict__ data, int64_t n,
                                          const int* __restrict__ perm, int64_t mb, int tile,
                                          float adv_shift, float adv_inv, float kl_beta,
                                          const LossCfg& cfg, float* __restrict__ out) {
  using L = ac::Layout<kD, kA>;
  constexpr int kRed = Smem<kD, kA>::kRed;
  // The dW1 rows of each tower's threads: [0, kD0) for tower 0, [kD0, kD)
  // for tower 1.
  constexpr int kD0 = (kD + 1) / 2, kD1 = kD - kD0;
  const int tid = threadIdx.x;
  const int tw = tid / kS;  // tower of this thread in the per-sample phases
  const int s = tid % kS;   // sample of this thread in the per-sample phases
  const int w1_rows = tw == 0 ? kD0 : kD1;

  // Gradient entries owned by this thread, summed over all its sub-blocks.
  const int k2 = s % kH, j2 = (s / kH) * 32;  // dW2[tw][k2][j2 .. j2 + 31]
  float g_w2[32];
#pragma unroll
  for (int c = 0; c < 32; ++c) g_w2[c] = 0.0f;
  float g_w1[kD0];  // dW1[tw * kD0 + c][unit s], c < w1_rows
#pragma unroll
  for (int c = 0; c < kD0; ++c) g_w1[c] = 0.0f;
  float g_b = 0.0f;       // tower 0 threads: db1[unit s]; tower 1: db2[unit s]
  float g_wpi = 0.0f;     // tid < H A: dwpi[tid / A][tid % A]
  float g_wvf = 0.0f;     // tid < 64: dwvf[tid]
  float g_red = 0.0f;     // tid < 2 A + 5: dbo (A + 1), dls (A), metrics (4)

  const int64_t n_sub = (mb + kS - 1) / kS;
  for (int64_t blk = blockIdx.x; blk < n_sub; blk += gridDim.x) {
    const int64_t q = blk * kS + s;
    const bool valid = q < mb;
    int64_t col = 0;
    if (valid) col = static_cast<int64_t>(perm[q / tile]) * tile + q % tile;

    // ---- P1: forward through this thread's tower ------------------------
    float x[kD];
#pragma unroll
    for (int d = 0; d < kD; ++d) x[d] = valid ? data[d * n + col] : 0.0f;
    if (tw == 0) {
#pragma unroll
      for (int d = 0; d < kD; ++d) sm.x[d][s] = x[d];
    }
    {
      float h1[kH];
#pragma unroll
      for (int k = 0; k < kH; ++k) {
        float z = sm.b1[tw][k];
#pragma unroll
        for (int d = 0; d < kD; ++d) z += sm.w1t[tw][k][d] * x[d];
        h1[k] = tanhf(z);
        sm.h1[tw * kH + k][s] = h1[k];
      }
      float mean[kA] = {};
      float value = 0.0f;
      for (int j = 0; j < kH; ++j) {
        const float4* w = reinterpret_cast<const float4*>(sm.w2t[tw][j]);
        float z = sm.b2[tw][j];
#pragma unroll
        for (int qq = 0; qq < kH / 4; ++qq) {
          const float4 v = w[qq];
          z += v.x * h1[4 * qq] + v.y * h1[4 * qq + 1] + v.z * h1[4 * qq + 2] +
               v.w * h1[4 * qq + 3];
        }
        const float h2 = tanhf(z);
        sm.h2[tw * kH + j][s] = h2;
        if (tw == 0) {
#pragma unroll
          for (int a = 0; a < kA; ++a) mean[a] += h2 * sm.wpi[j][a];
        } else {
          value += h2 * sm.wvf[j];
        }
      }
      if (tw == 0) {
#pragma unroll
        for (int a = 0; a < kA; ++a) sm.dout[a][s] = mean[a] + sm.bo[a];
      } else {
        sm.dout[kA][s] = value + sm.bo[kA];
      }
    }
    __syncthreads();

    // ---- P2: per-sample loss and its cotangent (tower-0 threads) --------
    if (tw == 0) {
      float dout[kA + 1] = {};
      float rd[kRed] = {};
      if (valid) {
        const float value = sm.dout[kA][s];
        float diff[kA], quad[kA], var[kA];
        float qsum = 0.0f, ls_sum = 0.0f;
#pragma unroll
        for (int a = 0; a < kA; ++a) {
          var[a] = expf(2.0f * sm.ls[a]);
          diff[a] = data[(kD + a) * n + col] - sm.dout[a][s];
          quad[a] = diff[a] * diff[a] / var[a];
          qsum += quad[a];
          ls_sum += sm.ls[a];
        }
        const float old_logp = data[(kD + kA) * n + col];
        const float old_value = data[(kD + kA + 1) * n + col];
        const float adv = (data[(kD + kA + 2) * n + col] - adv_shift) * adv_inv;
        const float ret = data[(kD + kA + 3) * n + col];
        const float logp = -0.5f * qsum - ls_sum - 0.5f * kA * ac::kLog2Pi;
        const float ratio = expf(logp - old_logp);
        const float kl = old_logp - logp;
        float dlogp, pg;
        if (kKl) {
          dlogp = -ratio * adv - kl_beta;
          pg = -(ratio * adv) + kl_beta * kl;
        } else {
          const float clipped = fminf(fmaxf(ratio, 1.0f - cfg.clip_eps), 1.0f + cfg.clip_eps);
          const float pg1 = ratio * adv, pg2 = clipped * adv;
          const float inside = fabsf(ratio - 1.0f) < cfg.clip_eps ? 1.0f : 0.0f;
          const float sel1 = pg1 < pg2 ? 1.0f : 0.0f;
          const float sel2 = pg2 < pg1 ? 1.0f : 0.0f;
          const float tie = 1.0f - sel1 - sel2;
          const float dmin = adv * (sel1 + sel2 * inside + 0.5f * tie * (1.0f + inside));
          dlogp = -dmin * ratio;
          pg = -fminf(pg1, pg2);
        }
        const float vdiff = value - old_value;
        const float vcl =
            old_value + fminf(fmaxf(vdiff, -cfg.value_clip_eps), cfg.value_clip_eps);
        const float e1 = value - ret, e2 = vcl - ret;
        const float sq1 = e1 * e1, sq2 = e2 * e2;
        const float vin = fabsf(vdiff) < cfg.value_clip_eps ? 1.0f : 0.0f;
        const float vs1 = sq1 > sq2 ? 1.0f : 0.0f;
        const float vs2 = sq2 > sq1 ? 1.0f : 0.0f;
        const float vtie = 1.0f - vs1 - vs2;
#pragma unroll
        for (int a = 0; a < kA; ++a) {
          dout[a] = dlogp * (diff[a] / var[a]);
          rd[a] = dlogp * (quad[a] - 1.0f);
        }
        dout[kA] = cfg.value_coef * (vs1 * e1 + vs2 * e2 * vin + 0.5f * vtie * (e1 + e2 * vin));
        rd[kA] = pg;
        rd[kA + 1] = 0.5f * fmaxf(sq1, sq2);
        rd[kA + 2] = kl;
        rd[kA + 3] = fabsf(ratio - 1.0f) > cfg.clip_eps ? 1.0f : 0.0f;
      }
#pragma unroll
      for (int a = 0; a <= kA; ++a) sm.dout[a][s] = dout[a];
#pragma unroll
      for (int r = 0; r < kRed; ++r) sm.red[r][s] = rd[r];
    }
    __syncthreads();

    // ---- P3: head gradients and the per-sample sums ----------------------
    {
      const int jp = tid / kA, ap = tid % kA;
      if (tid < kH * kA) {
        for (int ss = 0; ss < kS; ++ss) g_wpi += sm.h2[jp][ss] * sm.dout[ap][ss];
      }
      if (tid < kH) {
        for (int ss = 0; ss < kS; ++ss) g_wvf += sm.h2[kH + tid][ss] * sm.dout[kA][ss];
      }
      if (tid < kA + 1 + kRed) {
        const float* row = tid <= kA ? sm.dout[tid] : sm.red[tid - kA - 1];
        for (int ss = 0; ss < kS; ++ss) g_red += row[ss];
      }
    }
    __syncthreads();

    // ---- P4: dpre2 = (W_out dout) * (1 - h2^2), in place of h2 ------------
    for (int j = 0; j < kH; ++j) {
      float dh2;
      if (tw == 0) {
        dh2 = 0.0f;
#pragma unroll
        for (int a = 0; a < kA; ++a) dh2 += sm.wpi[j][a] * sm.dout[a][s];
      } else {
        dh2 = sm.wvf[j] * sm.dout[kA][s];
      }
      const float h2 = sm.h2[tw * kH + j][s];
      sm.h2[tw * kH + j][s] = dh2 * (1.0f - h2 * h2);
    }
    __syncthreads();

    // ---- P5: dW2 += h1 (x) dpre2, db2 -------------------------------------
    {
      const float* h1row = sm.h1[tw * kH + k2];
      for (int ss = 0; ss < kS; ++ss) {
        const float hk = h1row[ss];
#pragma unroll
        for (int c = 0; c < 32; ++c) g_w2[c] += hk * sm.h2[tw * kH + j2 + c][ss];
      }
      if (tw == 1) {
        for (int ss = 0; ss < kS; ++ss) g_b += sm.h2[s][ss];
      }
    }
    __syncthreads();

    // ---- P6: dpre1 = (W2 dpre2) * (1 - h1^2), in place of h1 --------------
    {
      float dh1[kH];
#pragma unroll
      for (int k = 0; k < kH; ++k) dh1[k] = 0.0f;
      for (int j = 0; j < kH; ++j) {
        const float dp = sm.h2[tw * kH + j][s];
        const float4* w = reinterpret_cast<const float4*>(sm.w2t[tw][j]);
#pragma unroll
        for (int qq = 0; qq < kH / 4; ++qq) {
          const float4 v = w[qq];
          dh1[4 * qq] += v.x * dp;
          dh1[4 * qq + 1] += v.y * dp;
          dh1[4 * qq + 2] += v.z * dp;
          dh1[4 * qq + 3] += v.w * dp;
        }
      }
#pragma unroll
      for (int k = 0; k < kH; ++k) {
        const float h1 = sm.h1[tw * kH + k][s];
        sm.h1[tw * kH + k][s] = dh1[k] * (1.0f - h1 * h1);
      }
    }
    __syncthreads();

    // ---- P7: dW1 += x (x) dpre1, db1 ---------------------------------------
    {
      const float* prow = sm.h1[s];  // fused unit s: tower s / 64
      for (int ss = 0; ss < kS; ++ss) {
        const float dp = prow[ss];
#pragma unroll
        for (int c = 0; c < kD0; ++c) {
          if (c < w1_rows) g_w1[c] += sm.x[tw * kD0 + c][ss] * dp;
        }
        if (tw == 0) g_b += dp;
      }
    }
    __syncthreads();
  }

  // ---- this CTA's partial sums, each entry written by exactly one thread --
  {
    const int base = L::tower_base(tw) + L::kW2 + k2 * kH + j2;
#pragma unroll
    for (int c = 0; c < 32; ++c) out[base + c] = g_w2[c];
  }
  {
    const int ut = s / kH, uu = s % kH;  // fused unit s = tower ut, unit uu
#pragma unroll
    for (int c = 0; c < kD0; ++c) {
      if (c < w1_rows) out[L::tower_base(ut) + L::kW1 + (tw * kD0 + c) * kH + uu] = g_w1[c];
    }
    out[L::tower_base(ut) + (tw == 0 ? L::kB1 : L::kB2) + uu] = g_b;
  }
  if (tid < kH * kA) out[L::kPiOutW + tid] = g_wpi;  // tid = j * A + a
  if (tid < kH) out[L::kVfOutW + tid] = g_wvf;
  if (tid < kA) {
    out[L::kPiOutB + tid] = g_red;
  } else if (tid == kA) {
    out[L::kVfOutB] = g_red;
  } else if (tid < 2 * kA + 1) {
    out[L::kLogStd + tid - kA - 1] = g_red;
  } else if (tid < kA + 1 + kRed) {
    out[L::kNetSize + tid - 2 * kA - 1] = g_red;
  }
}

}  // namespace ppo_loss
}  // namespace reinmav
