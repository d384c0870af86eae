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
// What bounds it: FP32 arithmetic (see ppo_loss.cu for the count).  Per
// tower and sub-block of 128 samples, five products carry nearly all of
// it: forward L1 (128 x D x 64), forward L2 (128 x 64 x 64), dW2 = h1^T
// dpre2 (64 x 64 over 128), dpre1 = dpre2 W2^T (128 x 64 x 64) and dW1 = x^T
// dpre1 (D x 64 over 128).  A serial dot product per output has an ILP of
// 1 and reads a shared-memory word per FMA, and an SM's shared memory
// serves 32 words a clock against 128 FMAs: an r x c tile of outputs needs
// (r + c) / (r c) words an FMA, at most 1/4 to keep up.
//
// Design: a CTA of 256 threads (one per SM, 8 warps) takes 128 samples at
// a time, and each product is a REGISTER-TILED OUTER PRODUCT.  In the two
// forward layers and in dpre1 a thread owns an 8 x 8 tile (8 samples x 8
// units of one tower: 64 independent FMA chains) and reads, per step of
// the contraction, 2 float4 of the sample operand (the same address across
// each 8 lanes: a broadcast) and 2 float4 of the weight operand (8 lanes
// read 128 contiguous bytes): 4 loads per 64 FMAs.  dW2 is a 4 x 8 tile of
// (k, j) entries per thread, stepped 4 samples at a time: 12 float4 loads
// per 128 FMAs; dW1 steps 4 samples at a time too.  The weight gradients
// (32 of dW2, up to 8 of dW1, a bias, a head entry) stay in registers for
// the CTA's whole share of the minibatch; each is summed over the samples
// in order, one sample after the other.  The order of every sum is fixed:
// the forward layers and the mean head FMA chains from 0 over k in order
// with the bias added last, which is the twin's float32 matmul and bias
// add bit for bit; the value head and logp -> ratio rounded one operation
// at a time, as the twin rounds them (ops/ppo_loss.py); dpre1 one product
// after another; the weight gradients sample by sample.  So the forward,
// the clip and value-clip decisions and each sample's cotangent are the
// twin's bit for bit, and a sample on a knife edge (1 +- clip_eps, the
// value clip) falls on the same side in both; the sums over samples keep
// their own order.
//
// The layouts that make every access free of bank conflicts: the
// activations are [tower * 64 + unit][sample] rows of kSP = 132 floats (a
// multiple of 4 for float4, and 132 = 4 mod 32, so that 8 consecutive rows
// start on 8 distinct 4-bank groups); a tile thread's 8 units are ug, ug +
// 8, ..., ug + 56 (so the 8 lanes of a quarter-warp write 8 consecutive
// rows), and the weights are kept with their output columns permuted by
// upos() so that those 8 units sit in two float4 at 4 ug and 32 + 4 ug.
// W2 is kept twice, (in, out) for L2 and (out, in) for dpre1.  Shared
// memory at D = 10, A = 4: 71 KiB of weights and 144 KiB of activations
// (215 KiB); each obs dim adds about 1 KiB (221 KiB at D = 16).
//
// The elementwise phases keep their order: thread (tower, sample) computes
// the heads, tower 0's threads the loss (P2), the head gradients sum over
// the samples one by one, and dpre2 = (W_out dout) * (1 - h2^2) loops over
// the units.  The D rows of dW1 are split between the thread halves, the
// first ceil(D / 2) rows to threads 0-127 and the rest to threads 128-255
// (5 + 5 at D = 10, 7 + 6 at D = 13, 8 + 8 at D = 16).  The gather:
// minibatch sample q reads column perm[q / tile] * tile + q % tile of the
// full (R, n) batch, so the minibatch is never stored.  The head-gradient
// phase gives thread tid the entry dW_pi[tid / A][tid % A]: all 256 threads
// at A = 4, the first 128 at A = 2.  No tensor cores: TF32 would round
// the products beyond the twins' tolerances.
//
// This body is the float32 instances' (compute_dtype None or "float32").
// The bf16 instances run ppo_loss_body_bf16.cuh, whose products are on the
// tensor cores, and no kernel instantiates this body with kBf true any
// more.  Its bf16 hooks (kBf, bf16r) stay: without them nvcc allocates the
// float32 K4 instances' registers otherwise at A = 4, and those instances
// are held instruction for instruction to the ones their digests were
// taken on (chip_smoke.py --only hashes, sass_report.py --against).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "actor_critic.cuh"
#include "bf16_round.cuh"

namespace reinmav {
namespace ppo_loss {

namespace ac = reinmav::ac;

constexpr int kH = ac::H;
constexpr int kS = 128;       // samples per sub-block
constexpr int kSP = kS + 4;   // padded row length: float4-aligned, 4 mod 32
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

// The column of output unit u in the permuted weight rows: a tile thread
// with unit group ug owns units ug + 8 i (i < 8), kept at 4 ug + i (i < 4)
// and 32 + 4 ug + i - 4 (i >= 4).
__host__ __device__ constexpr int upos(int u) {
  return ((u & 7) << 2) + ((u >> 3) & 3) + ((u >> 5) << 5);
}

template <int kD, int kA>
struct Smem {
  static constexpr int kRed = kA + 4;  // per-sample dls (A) and metric terms (4)
  float w1[2][kD][kH];   // (tower, in, upos(out))
  float b1[2][kH];
  float w2[2][kH][kH];   // (tower, in, upos(out))
  float w2t[2][kH][kH];  // (tower, out, upos(in))
  float b2[2][kH];
  float wpi[kH][kA];
  float wvf[kH];
  float bo[kA + 1];
  float ls[kA];
  alignas(16) float h1[2 * kH][kSP];  // h1, then dpre1
  alignas(16) float h2[2 * kH][kSP];  // h2, then dpre2
  alignas(16) float x[kD][kSP];
  float dout[kA + 1][kSP];  // the heads' output, then its cotangent
  float red[kRed][kSP];
};

struct LossCfg {
  float clip_eps, value_clip_eps, value_coef;
};

// The weights of the flat vector `net` into shared memory, rounded to bf16
// in the kBf instances (the biases and the log-std are not).  The loads go
// through L2 (__ldcg), never the non-coherent read-only path: in K4 the
// same vector is rewritten by other CTAs between passes.  The caller
// synchronises the block before the body reads them.
template <int kD, int kA, bool kBf>
__device__ __forceinline__ void load_weights(Smem<kD, kA>& sm, const float* net) {
  using L = ac::Layout<kD, kA>;
  using reinmav::bf16r;
  const int tid = threadIdx.x;
  for (int idx = tid; idx < kD * kH; idx += kThreads) {
    const int d = idx / kH, j = idx % kH;
    for (int t = 0; t < 2; ++t) {
      sm.w1[t][d][upos(j)] = bf16r<kBf>(__ldcg(net + L::tower_base(t) + L::kW1 + idx));
    }
  }
  for (int idx = tid; idx < kH * kH; idx += kThreads) {
    const int k = idx / kH, j = idx % kH;
    for (int t = 0; t < 2; ++t) {
      const float w = bf16r<kBf>(__ldcg(net + L::tower_base(t) + L::kW2 + idx));
      sm.w2[t][k][upos(j)] = w;
      sm.w2t[t][j][upos(k)] = w;
    }
  }
  for (int j = tid; j < kH; j += kThreads) {
    for (int t = 0; t < 2; ++t) {
      sm.b1[t][j] = __ldcg(net + L::tower_base(t) + L::kB1 + j);
      sm.b2[t][j] = __ldcg(net + L::tower_base(t) + L::kB2 + j);
    }
    for (int a = 0; a < kA; ++a) sm.wpi[j][a] = bf16r<kBf>(__ldcg(net + L::kPiOutW + j * kA + a));
    sm.wvf[j] = bf16r<kBf>(__ldcg(net + L::kVfOutW + j));
  }
  if (tid < kA) {
    sm.bo[tid] = __ldcg(net + L::kPiOutB + tid);
    sm.ls[tid] = __ldcg(net + L::kLogStd + tid);
  }
  if (tid == kA) sm.bo[kA] = __ldcg(net + L::kVfOutB);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void st4(float* p, float a, float b, float c, float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}

// acc[s][i] += sum over k < kK of a[k][s0 + s] * w[k][4 ug + i or 32 + 4 ug +
// i - 4], k in order: the 8 x 8 tile product of rows `a` (stride kSP, at the
// tile's first sample) and permuted weight rows `w` (stride kH, at 4 ug);
// with kRoundA, each `a` rounded to bf16 as it is loaded.
template <int kK, bool kRoundA>
__device__ __forceinline__ void tile8x8(const float* __restrict__ a, const float* __restrict__ w,
                                        float (&acc)[8][8]) {
  using reinmav::bf16r;
#pragma unroll 4
  for (int k = 0; k < kK; ++k) {
    const float4 a0 = bf16r<kRoundA>(ld4(a + k * kSP)), a1 = bf16r<kRoundA>(ld4(a + k * kSP + 4));
    const float4 w0 = ld4(w + k * kH), w1 = ld4(w + k * kH + 32);
    const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float wv[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
    for (int s = 0; s < 8; ++s) {
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[s][i] = fmaf(av[s], wv[i], acc[s][i]);
    }
  }
}

// A forward layer of one tower over the sub-block: h[unit][sample] =
// tanh(sum_k in[k][sample] * w[k][unit] + b[unit]) for the thread's tile (8
// samples from s0, units ug + 8 i): each sum an FMA chain from 0 over k in
// order, then the bias, the twin's float32 matmul (cuBLAS) and bias add
// bit for bit (chip_smoke.py's forward-order probe).  kRoundA rounds the
// inputs to bf16 as they are loaded.
template <int kK, bool kRoundA>
__device__ __forceinline__ void forward_layer(const float* __restrict__ in, const float* __restrict__ w,
                                              const float* __restrict__ b, float* __restrict__ out,
                                              int s0, int ug) {
  float acc[8][8];
#pragma unroll
  for (int s = 0; s < 8; ++s)
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[s][i] = 0.0f;
  tile8x8<kK, kRoundA>(in + s0, w + 4 * ug, acc);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float bi = b[ug + 8 * i];
    float* row = out + (ug + 8 * i) * kSP + s0;
    st4(row, tanhf(acc[0][i] + bi), tanhf(acc[1][i] + bi), tanhf(acc[2][i] + bi),
        tanhf(acc[3][i] + bi));
    st4(row + 4, tanhf(acc[4][i] + bi), tanhf(acc[5][i] + bi), tanhf(acc[6][i] + bi),
        tanhf(acc[7][i] + bi));
  }
}

// The loss gradient over the sub-blocks of 128 samples blockIdx.x,
// blockIdx.x + gridDim.x, ... of the minibatch of `mb` samples defined by
// `perm`, with the weights already in `sm`.  Writes the CTA's raw sums
// (out_size<kD, kA>() floats, each by exactly one thread) to `out`.  Its
// last writes to shared memory (x and red) and to `out` are not followed by
// a block synchronisation: the caller synchronises before it reuses them.
// kBf: the bf16 instance (the weights in `sm` already rounded by
// load_weights<kD, kA, true>).
template <int kD, int kA, bool kKl, bool kBf>
__device__ __forceinline__ void loss_body(Smem<kD, kA>& sm, const float* __restrict__ data, int64_t n,
                                          const int* __restrict__ perm, int64_t mb, int tile,
                                          float adv_shift, float adv_inv, float kl_beta,
                                          const LossCfg& cfg, float* __restrict__ out) {
  using L = ac::Layout<kD, kA>;
  using reinmav::bf16r;
  constexpr int kRed = Smem<kD, kA>::kRed;
  // The dW1 rows of each thread half: [0, kD0) for threads 0-127, [kD0,
  // kD) for threads 128-255.
  constexpr int kD0 = (kD + 1) / 2, kD1 = kD - kD0;
  const int tid = threadIdx.x;
  const int tw = tid / kS;  // tower of this thread in the per-sample and tile phases
  const int s = tid % kS;   // sample (per-sample phases), fused unit (dW1, db1, db2)
  const int w1_rows = tw == 0 ? kD0 : kD1;
  // Tile coordinates inside the tower: 16 groups of 8 samples (or of 4 k
  // rows of dW2) x 8 unit groups; a quarter-warp shares its first one.
  const int g16 = s >> 3, g8 = s & 7;
  float* const h1t = &sm.h1[tw * kH][0];
  float* const h2t = &sm.h2[tw * kH][0];

  // Gradient entries owned by this thread, summed over all its sub-blocks.
  float g_w2[4][8];  // dW2[tw][4 g16 + i][g8 + 8 m]
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int m = 0; m < 8; ++m) g_w2[i][m] = 0.0f;
  }
  float g_w1[kD0];  // dW1[tw * kD0 + c][fused unit s], c < w1_rows
#pragma unroll
  for (int c = 0; c < kD0; ++c) g_w1[c] = 0.0f;
  float g_b = 0.0f;       // threads 0-127: db1[fused unit s]; 128-255: db2[fused unit s]
  float g_wpi = 0.0f;     // tid < H A: dwpi[tid / A][tid % A]
  float g_wvf = 0.0f;     // tid < 64: dwvf[tid]
  float g_red = 0.0f;     // tid < 2 A + 5: dbo (A + 1), dls (A), metrics (4)

  // ---- P0: a sub-block's inputs, gathered into registers one sub-block
  // ahead (during P7) and staged in shared memory: the observations by
  // tower 0's threads into x, the action, old log-prob, old value, raw
  // advantage and return by tower 1's into red (P2 overwrites them there).
  constexpr int kPre = kD > kRed ? kD : kRed;
  float pre[kPre];
  auto fetch = [&](int64_t b) {
    const int64_t qb = b * kS + s;
    const bool ok = qb < mb;
    int64_t col = 0;
    if (ok) col = static_cast<int64_t>(perm[qb / tile]) * tile + qb % tile;
    const int64_t row0 = tw == 0 ? 0 : kD;
#pragma unroll
    for (int r = 0; r < kPre; ++r) {
      if (r < (tw == 0 ? kD : kRed)) pre[r] = ok ? data[(row0 + r) * n + col] : 0.0f;
    }
  };
  auto stage = [&]() {
#pragma unroll
    for (int r = 0; r < kPre; ++r) {
      if (tw == 0 && r < kD) sm.x[r][s] = bf16r<kBf>(pre[r]);
      if (tw == 1 && r < kRed) sm.red[r][s] = pre[r];
    }
  };
  fetch(blockIdx.x);
  stage();

  const int64_t n_sub = (mb + kS - 1) / kS;
  for (int64_t blk = blockIdx.x; blk < n_sub; blk += gridDim.x) {
    const bool valid = blk * kS + s < mb;
    __syncthreads();  // the staged inputs

    // ---- P1: forward through both towers, 8 x 8 tiles ---------------------
    forward_layer<kD, false>(&sm.x[0][0], &sm.w1[tw][0][0], sm.b1[tw], h1t, 8 * g16, g8);
    __syncthreads();
    forward_layer<kH, kBf>(h1t, &sm.w2[tw][0][0], sm.b2[tw], h2t, 8 * g16, g8);
    __syncthreads();
    // The heads: thread (tower, sample).
    if (tw == 0) {
      float mean[kA] = {};
#pragma unroll 8
      for (int j = 0; j < kH; ++j) {
        const float h2 = bf16r<kBf>(sm.h2[j][s]);
#pragma unroll
        for (int a = 0; a < kA; ++a) mean[a] += h2 * sm.wpi[j][a];
      }
#pragma unroll
      for (int a = 0; a < kA; ++a) sm.dout[a][s] = mean[a] + sm.bo[a];
    } else {
      // The value head rounds each product and sum apart, in j order, as
      // its twin does (a one-column matmul is no FMA chain in cuBLAS).
      float value = 0.0f;
#pragma unroll 8
      for (int j = 0; j < kH; ++j) {
        value = __fadd_rn(value, __fmul_rn(bf16r<kBf>(sm.h2[kH + j][s]), sm.wvf[j]));
      }
      sm.dout[kA][s] = value + sm.bo[kA];
    }
    __syncthreads();

    // ---- P2: per-sample loss and its cotangent (tower-0 threads) --------
    if (tw == 0) {
      float dout[kA + 1] = {};
      float rd[kRed] = {};
      if (valid) {
        const float value = sm.dout[kA][s];
        float diff[kA], quad[kA], var[kA];
        // logp and the ratio are rounded one operation at a time, in the
        // twin's order (ops/ppo_loss.py::logp_ratio), so that a ratio on the
        // clip edge clips in both or in neither.
        float qsum = 0.0f, ls_sum = 0.0f;
#pragma unroll
        for (int a = 0; a < kA; ++a) {
          var[a] = expf(2.0f * sm.ls[a]);
          diff[a] = __fsub_rn(sm.red[a][s], sm.dout[a][s]);
          quad[a] = __fdiv_rn(__fmul_rn(diff[a], diff[a]), var[a]);
          qsum = __fadd_rn(qsum, quad[a]);
          ls_sum = __fadd_rn(ls_sum, sm.ls[a]);
        }
        const float old_logp = sm.red[kA][s];
        const float old_value = sm.red[kA + 1][s];
        const float adv = (sm.red[kA + 2][s] - adv_shift) * adv_inv;
        const float ret = sm.red[kA + 3][s];
        const float logp = __fsub_rn(__fsub_rn(__fmul_rn(-0.5f, qsum), ls_sum),
                                     0.5f * kA * ac::kLog2Pi);
        const float ratio = expf(__fsub_rn(logp, old_logp));
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
        for (int ss = 0; ss < kS; ++ss) {
          g_wpi += bf16r<kBf>(sm.h2[jp][ss]) * bf16r<kBf>(sm.dout[ap][ss]);
        }
      }
      if (tid < kH) {
        for (int ss = 0; ss < kS; ++ss) {
          g_wvf += bf16r<kBf>(sm.h2[kH + tid][ss]) * bf16r<kBf>(sm.dout[kA][ss]);
        }
      }
      if (tid < kA + 1 + kRed) {
        const float* row = tid <= kA ? sm.dout[tid] : sm.red[tid - kA - 1];
        for (int ss = 0; ss < kS; ++ss) g_red += row[ss];
      }
    }
    __syncthreads();

    // ---- P4: dpre2 = (W_out dout) * (1 - h2^2), in place of h2, 8 units
    // loaded before any is stored (the stores may alias the loads) -----------
    {
      float dv[kA + 1];
#pragma unroll
      for (int a = 0; a <= kA; ++a) dv[a] = bf16r<kBf>(sm.dout[a][s]);
      for (int j0 = 0; j0 < kH; j0 += 8) {
        float dh2[8], h2[8];
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const int j = j0 + jj;
          if (tw == 0) {
            dh2[jj] = 0.0f;
#pragma unroll
            for (int a = 0; a < kA; ++a) dh2[jj] += sm.wpi[j][a] * dv[a];
          } else {
            dh2[jj] = sm.wvf[j] * dv[kA];
          }
          h2[jj] = h2t[j * kSP + s];
        }
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          h2t[(j0 + jj) * kSP + s] = dh2[jj] * (1.0f - h2[jj] * h2[jj]);
        }
      }
    }
    __syncthreads();

    // ---- P5: dW2 += h1 (x) dpre2 (4 x 8 tiles, 4 samples a step), db2 -----
    {
      const float* hrow = h1t + 4 * g16 * kSP;  // rows k = 4 g16 + i
      const float* drow = h2t + g8 * kSP;       // rows j = g8 + 8 m
      for (int ss = 0; ss < kS; ss += 4) {
        float4 hk[4], dj[8];
#pragma unroll
        for (int i = 0; i < 4; ++i) hk[i] = bf16r<kBf>(ld4(hrow + i * kSP + ss));
#pragma unroll
        for (int m = 0; m < 8; ++m) dj[m] = bf16r<kBf>(ld4(drow + 8 * m * kSP + ss));
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int m = 0; m < 8; ++m) {
            g_w2[i][m] = fmaf(hk[i].x, dj[m].x, g_w2[i][m]);
            g_w2[i][m] = fmaf(hk[i].y, dj[m].y, g_w2[i][m]);
            g_w2[i][m] = fmaf(hk[i].z, dj[m].z, g_w2[i][m]);
            g_w2[i][m] = fmaf(hk[i].w, dj[m].w, g_w2[i][m]);
          }
        }
      }
      if (tw == 1) {
        const float* prow = sm.h2[s];  // fused unit s
        for (int ss = 0; ss < kS; ss += 4) {
          const float4 v = ld4(prow + ss);
          g_b += v.x;
          g_b += v.y;
          g_b += v.z;
          g_b += v.w;
        }
      }
    }
    __syncthreads();

    // ---- P6: dpre1 = (dpre2 W2^T) * (1 - h1^2), 8 x 8 tiles, in place of h1
    {
      float acc[8][8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int ss = 0; ss < 8; ++ss) acc[ss][i] = 0.0f;
      }
      const int s0 = 8 * g16;
      tile8x8<kH, kBf>(h2t + s0, &sm.w2t[tw][0][0] + 4 * g8, acc);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        float* row = h1t + (g8 + 8 * i) * kSP + s0;
        const float4 h0 = ld4(row), h1 = ld4(row + 4);
        st4(row, acc[0][i] * (1.0f - h0.x * h0.x), acc[1][i] * (1.0f - h0.y * h0.y),
            acc[2][i] * (1.0f - h0.z * h0.z), acc[3][i] * (1.0f - h0.w * h0.w));
        st4(row + 4, acc[4][i] * (1.0f - h1.x * h1.x), acc[5][i] * (1.0f - h1.y * h1.y),
            acc[6][i] * (1.0f - h1.z * h1.z), acc[7][i] * (1.0f - h1.w * h1.w));
      }
    }
    __syncthreads();

    // ---- P7: dW1 += x (x) dpre1 (4 samples a step), db1; the next
    // sub-block's inputs are gathered meanwhile --------------------------------
    fetch(blk + gridDim.x);
    {
      const float* prow = sm.h1[s];  // fused unit s: tower s / 64
      const float* xrow = &sm.x[tw * kD0][0];
      for (int ss = 0; ss < kS; ss += 4) {
        const float4 dp = ld4(prow + ss);
        const float4 dr = bf16r<kBf>(dp);  // the x (x) dpre1 product's operand; db1 sums dp
#pragma unroll
        for (int c = 0; c < kD0; ++c) {
          if (c < w1_rows) {
            const float4 xv = ld4(xrow + c * kSP + ss);
            g_w1[c] = fmaf(xv.x, dr.x, g_w1[c]);
            g_w1[c] = fmaf(xv.y, dr.y, g_w1[c]);
            g_w1[c] = fmaf(xv.z, dr.z, g_w1[c]);
            g_w1[c] = fmaf(xv.w, dr.w, g_w1[c]);
          }
        }
        if (tw == 0) {
          g_b += dp.x;
          g_b += dp.y;
          g_b += dp.z;
          g_b += dp.w;
        }
      }
    }
    __syncthreads();
    stage();
  }

  // ---- this CTA's partial sums, each entry written by exactly one thread --
  {
    const int base = L::tower_base(tw) + L::kW2;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int m = 0; m < 8; ++m) out[base + (4 * g16 + i) * kH + g8 + 8 * m] = g_w2[i][m];
    }
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
