// The per-CTA device body of the PPO loss forward and hand-derived backward
// over a tanh actor-critic of two equal hidden layers of ANY width H from 1
// to 256 (and obs dims up to 32, action dims up to 8), its widths taken at
// run time: the wide instances of K3 (ppo_loss_wide.cu) and K4
// (ppo_update_wide.cu), templated on the KL switch and the dtype only.
//
// It computes what reinmav_tpu/ops/pallas_ppo.py::_tile_loss_grads
// (:71-173) computes, as ppo_loss_body.cuh does at H = 64: the clipped or
// adaptive-KL surrogate, value clipping, JAX's tie conventions for minimum
// / maximum (sel1/sel2/tie :121-127, vs1/vs2/vtie :136-141), the log-std
// gradient and the metric sums [pg, v, kl, clipfrac], as raw SUMS over the
// CTA's share of the minibatch in the flat parameter layout
// (actor_critic.cuh::RtLayout), then the 4 metric sums.  The orders that
// decide a knife edge are the 64 body's and the twin's
// (ops/ppo_loss.py): each forward unit an FMA chain from 0 over its inputs
// in order with the bias added last, the mean head likewise, the value head
// rounded one product and one sum at a time in j order, logp and the ratio
// one operation at a time.
//
// Why a body of its own: the 64 body keeps W2 twice and both towers'
// activations of 128 samples in shared memory, and every weight-gradient
// entry of the CTA in registers for its whole share of the minibatch.  At H
// = 256 W2 and W2^T alone take 2 x 2 x 256 x 256 x 4 B = 1 MiB, and the
// gradient 2 H^2 + 2 H D + ... floats, 135k at D = 10: neither fits a CTA.
//
// Design (simple first; the tensor cores are later work):
// - A CTA of 256 threads takes S samples at a time, S = 8 min(16,
//   floor(128 / ceil(H / 8))) (32 at H = 256, 64 at 128, 128 up to 64),
//   so that both towers' h1 and h2 of a sub-block fit in shared memory as
//   [unit][sample] rows of SP = S + 4 floats.
// - The units are padded to Hp = 8 G, G = ceil(H / 8), and a thread of a
//   tile owns the 8 interleaved units ug + G i (i < 8) of 8 samples: the
//   forward layers and dpre1 = dpre2 W2^T are 8 x 8 register-tiled outer
//   products (2 float4 of the sample operand, 2 float4 of the weights per
//   64 FMA), over the rows of the weight matrix staged kKC rows at a time
//   from global memory through L2 (both towers; W2 read as (out, in) for
//   dpre1), each row's units kept at upos() so that a thread's 8 units sit
//   in two float4.  Each output's chain runs over the rows in order across
//   the chunks.
// - The weight gradients (dW2, dW1) are 8 x 8 tiles of entries, each summed
//   over the sub-block's samples in order, 4 samples a step, straight into
//   the CTA's row of partial sums in global memory (read and written through
//   L2 by the one thread that owns the entry; no atomics).  The head
//   gradients, the bias gradients and the per-sample sums do the same.  The
//   CTA's row is zeroed at the start of the body.
// - bf16 (kBf): the operands of every product rounded to bf16 (weights as
//   they are staged, activations and cotangents as they are loaded), the
//   exact products summed in float32 on the FP32 pipes; the (1 - h^2)
//   factors and the bias gradients take the float32 values.  This is the
//   twin's bf16_mm (rl/networks.py).
//
// What bounds it: FP32 arithmetic, about 6 H^2 + 4 D H FMA a sample plus
// the heads (2 towers x (H D + H^2) forward, H^2 dW2 and H^2 dpre1 and H D
// dW1 backward); 8.2e5 operations a sample at H = 256, D = 10.  What holds
// this simple form above that: the partial sums' round trips through L2 a
// sub-block (2 H^2 entries read and written every S samples), the barriers
// between the chunks, and the heads and loss on S of the 256 threads.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "actor_critic.cuh"
#include "bf16_round.cuh"

namespace reinmav {
namespace ppo_wide {

namespace ac = reinmav::ac;
using reinmav::bf16r;

constexpr int kThreads = 256;
constexpr int kMaxHidden = 256;
constexpr int kMaxObs = 32;
constexpr int kMaxAction = 8;
constexpr int kKC = 16;               // weight rows staged at a time
constexpr int kSmemLimit = 232448;    // a block's dynamic shared memory on sm_90

__host__ __device__ inline int round4(int x) { return (x + 3) & ~3; }

// Samples a sub-block at hidden width h: 8 per sample group, at most 16
// groups, and 2 x groups x ceil(h / 8) tiles at most 256 (one a thread).
__host__ __device__ inline int sub_block_samples(int h) {
  const int q = 128 / ((h + 7) / 8);
  return 8 * (q < 16 ? q : 16);
}

// The run-time shape of the body and its shared memory, in floats.
struct Shape {
  int D, A, H;
  int G, Hp;   // unit groups (units ug + G i, i < 8), Hp = 8 G
  int Gd, Dp;  // obs row groups for dW1 (rows cg + Gd i), Dp = 8 Gd
  int S, SP;   // samples a sub-block, padded row length (S + 4: 4 mod 8)
  int h1, h2, x, inp, dout, red, wst, b1, b2, wpi, wvf, bo, ls, total;
};

__host__ __device__ inline Shape make_shape(int d, int a, int h) {
  Shape s;
  s.D = d;
  s.A = a;
  s.H = h;
  s.G = (h + 7) / 8;
  s.Hp = 8 * s.G;
  s.Gd = (d + 7) / 8;
  s.Dp = 8 * s.Gd;
  s.S = sub_block_samples(h);
  s.SP = s.S + 4;
  int off = 0;
  s.h1 = off;  // (tower, unit, sample): h1, then dpre1
  off += round4(2 * s.Hp * s.SP);
  s.h2 = off;  // h2, then dpre2
  off += round4(2 * s.Hp * s.SP);
  s.x = off;  // (obs row, sample), rows D..Dp zero
  off += round4(s.Dp * s.SP);
  s.inp = off;  // action (A), old logp, old value, raw advantage, return
  off += round4((a + 4) * s.SP);
  s.dout = off;  // the heads' outputs, then their cotangents
  off += round4((a + 1) * s.SP);
  s.red = off;  // per-sample dls (A) and metric terms (4)
  off += round4((a + 4) * s.SP);
  s.wst = off;  // (tower, staged row, upos(unit)); K4's block scratch between passes
  off += round4(2 * kKC * s.Hp);
  s.b1 = off;
  off += round4(2 * s.Hp);
  s.b2 = off;
  off += round4(2 * s.Hp);
  s.wpi = off;  // (unit, action)
  off += round4(s.Hp * a);
  s.wvf = off;
  off += round4(s.Hp);
  s.bo = off;  // pi_out.b (A), vf_out.b
  off += round4(a + 1);
  s.ls = off;
  off += round4(a);
  s.total = off;
  return s;
}

__host__ __device__ inline int smem_bytes(const Shape& s) { return 4 * s.total; }

// Whether the wide body takes these widths (obs d, action a, hidden h).
__host__ __device__ inline bool takes(int d, int a, int h) {
  return d >= 1 && d <= kMaxObs && a >= 1 && a <= kMaxAction && h >= 1 && h <= kMaxHidden &&
         smem_bytes(make_shape(d, a, h)) <= kSmemLimit;
}

struct LossCfg {
  float clip_eps, value_clip_eps, value_coef;
  float log_norm;  // 0.5 A log(2 pi), rounded to float from double as the twin's scalar
};

// 0.5 A log(2 pi) as the twin's Python scalar (ops/ppo_loss.py::logp_ratio):
// computed in double, rounded to float once.
inline float log_norm(int adim) { return static_cast<float>(0.5 * adim * 1.8378770664093453); }

// The column of unit u in a staged weight row: unit ug + G i at
// 4 (G (i / 4) + ug) + i % 4, so a thread's 8 units are two float4.
__device__ __forceinline__ int upos(int u, int g) {
  const int ug = u % g, i = u / g;
  return 4 * (g * (i >> 2) + ug) + (i & 3);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void st4(float* p, float a, float b, float c, float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}

// The biases, the heads' weights and the log-std of `net` into shared
// memory (the heads' weights rounded to bf16 in kBf), the padded units
// zero.  Through L2 (__ldcg): in K4 other CTAs rewrite `net` between
// passes.  The caller synchronises the block before they are read.
template <bool kBf>
__device__ __forceinline__ void load_small(float* sm, const Shape& sh, const ac::RtLayout& L,
                                           const float* net) {
  const int tid = threadIdx.x;
  for (int idx = tid; idx < 2 * sh.Hp; idx += kThreads) {
    const int t = idx / sh.Hp, u = idx % sh.Hp;
    const bool real = u < sh.H;
    sm[sh.b1 + idx] = real ? __ldcg(net + L.tower_base(t) + u) : 0.0f;
    sm[sh.b2 + idx] = real ? __ldcg(net + L.tower_base(t) + L.b2 + u) : 0.0f;
  }
  for (int idx = tid; idx < sh.Hp * sh.A; idx += kThreads) {
    sm[sh.wpi + idx] = idx < sh.H * sh.A ? bf16r<kBf>(__ldcg(net + L.pi_out_w + idx)) : 0.0f;
  }
  for (int j = tid; j < sh.Hp; j += kThreads) {
    sm[sh.wvf + j] = j < sh.H ? bf16r<kBf>(__ldcg(net + L.vf_out_w + j)) : 0.0f;
  }
  if (tid < sh.A) {
    sm[sh.bo + tid] = __ldcg(net + L.pi_out_b + tid);
    sm[sh.ls + tid] = __ldcg(net + tid);  // log_std at 0
  }
  if (tid == sh.A) sm[sh.bo + sh.A] = __ldcg(net + L.vf_out_b);
}

// Rows [k0, k0 + kc) of both towers' weight matrix into the staging area
// (tower t at t kKC Hp, row stride Hp, unit u at upos(u)), rounded to bf16
// in kBf, the padded units zero.  The matrix lies at `off` in each tower:
// element (row k, unit u) is W[k][u] (W1 or W2 as (in, out)), or with
// kTrans W2[u][k] (W2 as (out, in), for dpre1).  Each thread's unit (or
// row) is fixed for the call, so no index is divided per element, and the
// loads of a thread are independent of one another (unrolled, several in
// flight); consecutive threads read consecutive addresses: along the unit
// for W[k][u], along the row for W2[u][k].
template <bool kBf, bool kTrans>
__device__ __forceinline__ void stage(float* __restrict__ wst, const Shape& sh,
                                      const ac::RtLayout& L, const float* net, int off, int k0,
                                      int kc) {
  const int tid = threadIdx.x;
  if (kTrans) {
    constexpr int kStep = kThreads / kKC;  // units staged at once
    const int kk = tid % kKC;
    if (kk >= kc) return;
    int u = tid / kKC, ug = u % sh.G, i = u / sh.G;
#pragma unroll 4
    for (; u < sh.Hp; u += kStep) {
      const int p = 4 * (sh.G * (i >> 2) + ug) + (i & 3);  // upos(u)
      for (int t = 0; t < 2; ++t) {
        const float w =
            u < sh.H ? bf16r<kBf>(__ldcg(net + L.tower_base(t) + off + u * sh.H + k0 + kk)) : 0.0f;
        wst[t * kKC * sh.Hp + kk * sh.Hp + p] = w;
      }
      ug += kStep;
      while (ug >= sh.G) {
        ug -= sh.G;
        ++i;
      }
    }
  } else {
    const int rstep = kThreads / sh.Hp;  // rows staged at once
    const int u = tid % sh.Hp, r0 = tid / sh.Hp;
    if (r0 >= rstep) return;
    const int p = upos(u, sh.G);
#pragma unroll 8
    for (int r = r0; r < 2 * kc; r += rstep) {
      const int t = r >= kc ? 1 : 0, kk = r - t * kc;
      const float w =
          u < sh.H ? bf16r<kBf>(__ldcg(net + L.tower_base(t) + off + (k0 + kk) * sh.H + u)) : 0.0f;
      wst[t * kKC * sh.Hp + kk * sh.Hp + p] = w;
    }
  }
}

// acc[s][i] += sum over k < kc of a[k][s] * w[k][unit ug + G i], k in order:
// `a` at the chunk's first input row and the tile's first sample (row
// stride SP), `w` at the tower's staged chunk; kRoundA rounds each `a` to
// bf16 as it is loaded.
template <bool kRoundA>
__device__ __forceinline__ void tile_chunk(const float* __restrict__ a, const float* __restrict__ w,
                                           const Shape& sh, int ug, int kc, float (&acc)[8][8]) {
  const float* wp = w + 4 * ug;
  const int g4 = 4 * sh.G;
#pragma unroll 2
  for (int k = 0; k < kc; ++k) {
    const float4 a0 = bf16r<kRoundA>(ld4(a + k * sh.SP));
    const float4 a1 = bf16r<kRoundA>(ld4(a + k * sh.SP + 4));
    const float4 w0 = ld4(wp + k * sh.Hp), w1 = ld4(wp + k * sh.Hp + g4);
    const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float wv[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
    for (int s = 0; s < 8; ++s) {
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[s][i] = fmaf(av[s], wv[i], acc[s][i]);
    }
  }
}

// A thread's tile of the forward layers and of dpre1: tower tw, samples
// s0..s0+7, units ug + G i; `active` false for the threads beyond the 2 S/8
// G tiles.
struct Tile {
  bool active;
  int tw, s0, ug;
};

__device__ __forceinline__ Tile my_tile(const Shape& sh) {
  const int per_tower = (sh.S / 8) * sh.G;
  const int t = threadIdx.x;
  Tile tl;
  tl.active = t < 2 * per_tower;
  tl.tw = t / per_tower;
  if (tl.tw > 1) tl.tw = 1;
  const int rem = t % per_tower;
  tl.s0 = 8 * (rem / sh.G);
  tl.ug = rem % sh.G;
  return tl;
}

// acc = the tile's product over the K rows of the chain: in_t[k][s] (tower
// t's input rows, stride SP) times the tower's matrix at `off` (see stage),
// the rows staged kKC at a time.  Every thread joins the barriers.
template <bool kBf, bool kTrans, bool kRoundA>
__device__ __forceinline__ void tile_product(float* sm, const Shape& sh, const ac::RtLayout& L,
                                             const float* net, int off, const float* in0,
                                             const float* in1, int K, const Tile& tl,
                                             float (&acc)[8][8]) {
#pragma unroll
  for (int s = 0; s < 8; ++s) {
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[s][i] = 0.0f;
  }
  const float* in = (tl.tw == 0 ? in0 : in1) + tl.s0;
  for (int k0 = 0; k0 < K; k0 += kKC) {
    const int kc = K - k0 < kKC ? K - k0 : kKC;
    __syncthreads();  // the chunk before is read
    stage<kBf, kTrans>(sm + sh.wst, sh, L, net, off, k0, kc);
    __syncthreads();
    if (tl.active) {
      tile_chunk<kRoundA>(in + k0 * sh.SP, sm + sh.wst + tl.tw * kKC * sh.Hp, sh, tl.ug, kc, acc);
    }
  }
}

// A forward layer's tile: out[u][s] = tanh(acc[s][i] + b[u]) for the
// tile's units u = ug + G i (the padded ones tanh(0) = 0).
__device__ __forceinline__ void forward_store(const float (&acc)[8][8], const float* b, float* out,
                                              const Shape& sh, const Tile& tl) {
  if (!tl.active) return;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int u = tl.ug + sh.G * i;
    const float bi = b[tl.tw * sh.Hp + u];
    float* row = out + (tl.tw * sh.Hp + u) * sh.SP + tl.s0;
    st4(row, tanhf(acc[0][i] + bi), tanhf(acc[1][i] + bi), tanhf(acc[2][i] + bi),
        tanhf(acc[3][i] + bi));
    st4(row + 4, tanhf(acc[4][i] + bi), tanhf(acc[5][i] + bi), tanhf(acc[6][i] + bi),
        tanhf(acc[7][i] + bi));
  }
}

// A weight-gradient tile: out[r_i * H + c_m] += sum over the sub-block's
// samples s, in order, of rows[r_i][s] * cols[c_m][s], for r_i = rg + gr i
// < R and c_m = cg + G m < H (`rows` R real rows of a padded 8 gr, `cols`
// the tower's Hp unit rows); both operands rounded to bf16 in kBf.  `out`
// is the CTA's row of partial sums at the matrix, read and written through
// L2 by this thread only.
template <bool kBf>
__device__ __forceinline__ void wgrad_tile(const float* __restrict__ rows, int gr, int R,
                                           const float* __restrict__ cols, const Shape& sh,
                                           int rg, int cg, float* __restrict__ out) {
  float g[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int m = 0; m < 8; ++m) {
      const int r = rg + gr * i, c = cg + sh.G * m;
      g[i][m] = r < R && c < sh.H ? __ldcg(out + r * sh.H + c) : 0.0f;
    }
  }
  const float* rp = rows + rg * sh.SP;
  const float* cp = cols + cg * sh.SP;
  for (int s = 0; s < sh.S; s += 4) {
    float4 rv[8], cv[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) rv[i] = bf16r<kBf>(ld4(rp + gr * i * sh.SP + s));
#pragma unroll
    for (int m = 0; m < 8; ++m) cv[m] = bf16r<kBf>(ld4(cp + sh.G * m * sh.SP + s));
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int m = 0; m < 8; ++m) {
        g[i][m] = fmaf(rv[i].x, cv[m].x, g[i][m]);
        g[i][m] = fmaf(rv[i].y, cv[m].y, g[i][m]);
        g[i][m] = fmaf(rv[i].z, cv[m].z, g[i][m]);
        g[i][m] = fmaf(rv[i].w, cv[m].w, g[i][m]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int m = 0; m < 8; ++m) {
      const int r = rg + gr * i, c = cg + sh.G * m;
      if (r < R && c < sh.H) __stcg(out + r * sh.H + c, g[i][m]);
    }
  }
}

// Both towers' weight gradient of one layer: rows_t (tower t's input
// activations: x for W1, shared by both towers, or h1) against cols_t
// (tower t's dpre), each entry of each tower's matrix at `off` owned by one
// thread.
template <bool kBf>
__device__ __forceinline__ void wgrad(const float* rows0, const float* rows1, int gr, int R,
                                      const float* cols, const Shape& sh, const ac::RtLayout& L,
                                      int off, float* out) {
  const int per_tower = gr * sh.G;
  for (int t = threadIdx.x; t < 2 * per_tower; t += kThreads) {
    const int tw = t / per_tower, rem = t % per_tower;
    wgrad_tile<kBf>(tw == 0 ? rows0 : rows1, gr, R, cols + tw * sh.Hp * sh.SP, sh, rem / sh.G,
                    rem % sh.G, out + L.tower_base(tw) + off);
  }
}

// out[off + u] += sum over the sub-block's samples, in order, of
// rows[t Hp + u][s], for both towers' units u < H (a bias gradient).
__device__ __forceinline__ void bias_grad(const float* rows, const Shape& sh,
                                          const ac::RtLayout& L, int off, float* out) {
  for (int e = threadIdx.x; e < 2 * sh.H; e += kThreads) {
    const int t = e / sh.H, u = e % sh.H;
    float* o = out + L.tower_base(t) + off + u;
    float g = __ldcg(o);
    const float* row = rows + (t * sh.Hp + u) * sh.SP;
    for (int s = 0; s < sh.S; s += 4) {
      const float4 v = ld4(row + s);
      g += v.x;
      g += v.y;
      g += v.z;
      g += v.w;
    }
    __stcg(o, g);
  }
}

// The loss gradient over the sub-blocks of S samples blockIdx.x,
// blockIdx.x + gridDim.x, ... of the minibatch of `mb` samples defined by
// `perm`, with load_small's values already in `sm` (the caller synchronised
// after it).  Zeroes, then accumulates, the CTA's raw sums (the flat
// gradient, then the 4 metric sums) in `out`; the weights are read from
// `net`.  Ends with a block synchronisation.
template <bool kKl, bool kBf>
__device__ __forceinline__ void loss_body(float* sm, const Shape& sh, const ac::RtLayout& L,
                                          const float* __restrict__ net,
                                          const float* __restrict__ data, int64_t n,
                                          const int* __restrict__ perm, int64_t mb, int tile,
                                          float adv_shift, float adv_inv, float kl_beta,
                                          const LossCfg& cfg, float* __restrict__ out) {
  const int tid = threadIdx.x;
  const int D = sh.D, A = sh.A, H = sh.H, S = sh.S, SP = sh.SP;
  const int n_out = L.net_size + 4;
  for (int e = tid; e < n_out; e += kThreads) __stcg(out + e, 0.0f);
  for (int e = tid; e < (sh.Dp - D) * SP; e += kThreads) sm[sh.x + D * SP + e] = 0.0f;
  float* const h1 = sm + sh.h1;
  float* const h2 = sm + sh.h2;
  float* const x = sm + sh.x;
  float* const inp = sm + sh.inp;
  float* const dout = sm + sh.dout;
  float* const red = sm + sh.red;
  const Tile tl = my_tile(sh);
  // The per-sample row phases (P0, P4): thread (rows r0, r0 + rstep, ...,
  // sample s_own), so that no index is divided per element.
  const int s_own = tid % S, r0 = tid / S, rstep = kThreads / S;
  float acc[8][8];
  __syncthreads();  // the zeroed row before any thread adds to it

  const int64_t n_sub = (mb + S - 1) / S;
  for (int64_t blk = blockIdx.x; blk < n_sub; blk += gridDim.x) {
    // ---- P0: the sub-block's inputs, gathered: sample q of the minibatch
    // is column perm[q / tile] * tile + q % tile of `data`; thread (row r0 +
    // k rstep, sample s) -----------------------------------------------------
    if (r0 < rstep) {
      const int64_t q = blk * S + s_own;
      const bool ok = q < mb;
      const int64_t col = ok ? static_cast<int64_t>(perm[q / tile]) * tile + q % tile : 0;
#pragma unroll 4
      for (int r = r0; r < D + A + 4; r += rstep) {
        const float v = ok ? data[r * n + col] : 0.0f;
        if (r < D) {
          x[r * SP + s_own] = bf16r<kBf>(v);
        } else {
          inp[(r - D) * SP + s_own] = v;
        }
      }
    }
    __syncthreads();

    // ---- P1: forward through both towers, 8 x 8 tiles --------------------
    tile_product<kBf, false, false>(sm, sh, L, net, L.w1, x, x, D, tl, acc);
    forward_store(acc, sm + sh.b1, h1, sh, tl);
    tile_product<kBf, false, kBf>(sm, sh, L, net, L.w2, h1, h1 + sh.Hp * SP, H, tl, acc);
    forward_store(acc, sm + sh.b2, h2, sh, tl);
    __syncthreads();
    // The heads: thread (tower, sample).
    if (tid < 2 * S) {
      const int tw = tid / S, s = tid % S;
      if (tw == 0) {
        for (int a = 0; a < A; ++a) {
          float mean = 0.0f;
          for (int j = 0; j < H; ++j) {
            mean = fmaf(bf16r<kBf>(h2[j * SP + s]), sm[sh.wpi + j * A + a], mean);
          }
          dout[a * SP + s] = mean + sm[sh.bo + a];
        }
      } else {
        // The value head rounds each product and sum apart, in j order, as
        // its twin does (ops/ppo_loss.py::value_head).
        float value = 0.0f;
        for (int j = 0; j < H; ++j) {
          value = __fadd_rn(value, __fmul_rn(bf16r<kBf>(h2[(sh.Hp + j) * SP + s]),
                                             sm[sh.wvf + j]));
        }
        dout[A * SP + s] = value + sm[sh.bo + A];
      }
    }
    __syncthreads();

    // ---- P2: per-sample loss and its cotangent (threads 0..S-1) ----------
    if (tid < S) {
      const int s = tid;
      if (blk * S + s < mb) {
        const float* ls = sm + sh.ls;
        const float value = dout[A * SP + s];
        // logp and the ratio rounded one operation at a time, in the twin's
        // order (ops/ppo_loss.py::logp_ratio).
        float qsum = 0.0f, ls_sum = 0.0f;
        for (int a = 0; a < A; ++a) {
          const float var = expf(2.0f * ls[a]);
          const float diff = __fsub_rn(inp[a * SP + s], dout[a * SP + s]);
          qsum = __fadd_rn(qsum, __fdiv_rn(__fmul_rn(diff, diff), var));
          ls_sum = __fadd_rn(ls_sum, ls[a]);
        }
        const float old_logp = inp[A * SP + s];
        const float old_value = inp[(A + 1) * SP + s];
        const float adv = (inp[(A + 2) * SP + s] - adv_shift) * adv_inv;
        const float ret = inp[(A + 3) * SP + s];
        const float logp = __fsub_rn(__fsub_rn(__fmul_rn(-0.5f, qsum), ls_sum), cfg.log_norm);
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
        for (int a = 0; a < A; ++a) {
          const float var = expf(2.0f * ls[a]);
          const float diff = __fsub_rn(inp[a * SP + s], dout[a * SP + s]);
          const float quad = __fdiv_rn(__fmul_rn(diff, diff), var);
          dout[a * SP + s] = dlogp * (diff / var);
          red[a * SP + s] = dlogp * (quad - 1.0f);
        }
        dout[A * SP + s] =
            cfg.value_coef * (vs1 * e1 + vs2 * e2 * vin + 0.5f * vtie * (e1 + e2 * vin));
        red[A * SP + s] = pg;
        red[(A + 1) * SP + s] = 0.5f * fmaxf(sq1, sq2);
        red[(A + 2) * SP + s] = kl;
        red[(A + 3) * SP + s] = fabsf(ratio - 1.0f) > cfg.clip_eps ? 1.0f : 0.0f;
      } else {
        for (int a = 0; a <= A; ++a) dout[a * SP + s] = 0.0f;
        for (int r = 0; r < A + 4; ++r) red[r * SP + s] = 0.0f;
      }
    }
    __syncthreads();

    // ---- P3: the heads' gradients and the per-sample sums ----------------
    {
      const int n_wpi = H * A, n_head = n_wpi + H + (A + 1) + (A + 4);
      for (int e = tid; e < n_head; e += kThreads) {
        float* o;
        float g;
        if (e < n_wpi) {  // dwpi[j][a], e = j A + a
          const int j = e / A, a = e % A;
          o = out + L.pi_out_w + e;
          g = __ldcg(o);
          for (int s = 0; s < S; ++s) {
            g += bf16r<kBf>(h2[j * SP + s]) * bf16r<kBf>(dout[a * SP + s]);
          }
        } else if (e < n_wpi + H) {  // dwvf[j]
          const int j = e - n_wpi;
          o = out + L.vf_out_w + j;
          g = __ldcg(o);
          for (int s = 0; s < S; ++s) {
            g += bf16r<kBf>(h2[(sh.Hp + j) * SP + s]) * bf16r<kBf>(dout[A * SP + s]);
          }
        } else {
          const int r = e - n_wpi - H;  // dbo (A + 1), then dls (A) and the metrics (4)
          const float* row = r <= A ? dout + r * SP : red + (r - A - 1) * SP;
          o = r < A ? out + L.pi_out_b + r
              : r == A ? out + L.vf_out_b
              : r < 2 * A + 1 ? out + (r - A - 1)
              : out + L.net_size + (r - 2 * A - 1);
          g = __ldcg(o);
          for (int s = 0; s < S; ++s) g += row[s];
        }
        __stcg(o, g);
      }
    }
    __syncthreads();

    // ---- P4: dpre2 = (W_out dout) * (1 - h2^2), in place of h2; thread
    // (rows r0 + k rstep of both towers' units, sample s_own) ---------------
    if (r0 < rstep) {
      const int s = s_own;
      for (int r = r0; r < 2 * H; r += rstep) {
        const int t = r >= H ? 1 : 0, u = r - t * H;
        float dh;
        if (t == 0) {
          dh = 0.0f;
          for (int a = 0; a < A; ++a) {
            dh += sm[sh.wpi + u * A + a] * bf16r<kBf>(dout[a * SP + s]);
          }
        } else {
          dh = sm[sh.wvf + u] * bf16r<kBf>(dout[A * SP + s]);
        }
        float* p = h2 + (t * sh.Hp + u) * SP + s;
        const float h = *p;
        *p = dh * (1.0f - h * h);
      }
    }
    __syncthreads();

    // ---- P5: dW2 += h1 (x) dpre2, db2 -------------------------------------
    wgrad<kBf>(h1, h1 + sh.Hp * SP, sh.G, H, h2, sh, L, L.w2, out);
    bias_grad(h2, sh, L, L.b2, out);
    __syncthreads();

    // ---- P6: dpre1 = (dpre2 W2^T) * (1 - h1^2), in place of h1 ----------
    tile_product<kBf, true, kBf>(sm, sh, L, net, L.w2, h2, h2 + sh.Hp * SP, H, tl, acc);
    if (tl.active) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        float* row = h1 + (tl.tw * sh.Hp + tl.ug + sh.G * i) * SP + tl.s0;
        const float4 p0 = ld4(row), p1 = ld4(row + 4);
        st4(row, acc[0][i] * (1.0f - p0.x * p0.x), acc[1][i] * (1.0f - p0.y * p0.y),
            acc[2][i] * (1.0f - p0.z * p0.z), acc[3][i] * (1.0f - p0.w * p0.w));
        st4(row + 4, acc[4][i] * (1.0f - p1.x * p1.x), acc[5][i] * (1.0f - p1.y * p1.y),
            acc[6][i] * (1.0f - p1.z * p1.z), acc[7][i] * (1.0f - p1.w * p1.w));
      }
    }
    __syncthreads();

    // ---- P7: dW1 += x (x) dpre1, db1 ---------------------------------------
    wgrad<kBf>(x, x, sh.Gd, D, h1, sh, L, L.w1, out);
    bias_grad(h1, sh, L, 0, out);
    __syncthreads();
  }
}

}  // namespace ppo_wide
}  // namespace reinmav
