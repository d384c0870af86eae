// The per-CTA device body of K3 and K4's bf16 instances (compute_dtype
// "bfloat16"): the PPO loss forward and hand-derived backward of
// ppo_loss_body.cuh, with its products on the tensor cores
// (mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32).  The same
// function as the float32 body: reinmav_tpu/ops/pallas_ppo.py::
// _tile_loss_grads (:71-173) with the TPU kernel's _mm (:63-67), the
// operands of the forward (:92-94) and of the five backward products
// (:145-155) rounded to bf16 and the exact products summed in float32.  It
// writes the same raw sums, in the same flat layout, each entry by exactly
// one thread, so K3's and K4's reductions across CTAs are unchanged.
//
// What bounds it: the products are 56k operations a sample at D = 10
// (ppo_loss.cu), 0.057 us a thousand samples at 989 TFLOP/s; between them
// sit about 256 tanhf a sample (two layers of two towers of 64 units, each
// an ex2 and a reciprocal on the SFU and a branch), the loss, and the
// products of the backward, each waiting on the one before it.  The float32
// body ran the products as FP32 FMAs from shared memory (8 x 8 register
// tiles, 67 TFLOP/s at best) and, in its bf16 instances, rounded each
// operand inside the inner loops.
//
// Design.  A CTA of 256 threads (8 warps, one CTA an SM) takes 64 samples
// at a time.  Warp w runs the whole per-sample chain of tower w / 4 (0 the
// policy, 1 the value) on the 16 samples 16 (w % 4) .. + 15, one m16 row
// of every product, with no block barrier inside it:
//   L1   h1 = tanh(x W1 + b1)          16 x 64 x 16 (D padded to 16 with zeros)
//   L2   h2 = tanh(h1 W2 + b2)         16 x 64 x 64
//   head mean or value = h2 W_out      16 x 8 x 64 (A or 1 columns of 8 used)
//   loss the tower's part of the loss and its cotangent dout (lanes 0-15,
//        a sample each: the policy terms in tower 0, the value terms in
//        tower 1; each needs only its own head)
//   dh2  = dout W_out^T                16 x 64 x 16 (A or 1 of 16 used)
//   dpre2 = dh2 (1 - h2^2), dpre1 = (dpre2 W2^T) (1 - h1^2)   16 x 64 x 64
// The accumulator fragment of an m16n8 product is the A fragment of the
// next product's m16k16 step (two adjacent n8 tiles), so h1 -> L2, h2 ->
// the head and dpre2 -> dpre1 pass in registers, rounded to bf16 once,
// when packed.  The float32 h1, h2 that the (1 - h^2) factors read stay in
// the registers of the thread that computed them (32 + 32 a thread); the
// bias gradients sum the float32 dpre2, dpre1 of the registers: over the
// warp's two rows a thread, then over its 8 row groups by shuffles, then
// over the 4 sample warps of a tower in order, after the barrier.
// Each operand is rounded once, when it is written: the weights when
// staged (W2 once, in bf16, row (in, out): L2 reads it with ldmatrix.trans,
// dpre1 with ldmatrix), the obs when staged, h1, h2, dpre2, dpre1 and dout
// when packed or stored.  After one barrier, the weight gradients sum over
// the sub-block's 64 samples from the rows the warps stored:
//   dW2 = h1^T dpre2, a 32 x 32 quarter of one tower's 64 x 64 a warp;
//   dW1 = x^T dpre1, 16 (D padded) x 16 units a warp;
//   dW_pi, dw_vf = h2^T dout, 16 units x 8 a warp,
// with ldmatrix.trans on the sample-major rows, into accumulator fragments
// that stay in the registers for the CTA's whole share of the minibatch
// (32 + 8 + 4 floats a thread).  The per-sample sums (the head biases, the
// log-std, the 4 metrics) add the loss lanes' float32 terms in sample
// order.  Two barriers a sub-block: the inputs of sub-block b + 1 are
// staged into the other of two buffers while the weight gradients of b
// still read b's.
//
// Why mma.sync and not wgmma: each product is small (K <= 64 a
// sub-block), elementwise phases (tanhf, the loss) sit between the
// products and depend on them, and the weight gradients accumulate in
// registers across sub-blocks; wgmma's 64-row warpgroup tiles and its
// asynchronous issue would need the chain of 16-sample rows regrouped
// into warpgroups and barriers between the dependent products.  The
// tensor pipe is not what limits this body: the tanhf and the loss, on
// two warps a scheduler, take more issue slots than the products.
//
// Numerics: the exact bf16 products of the twin (ops/ppo_loss.py with
// compute_dtype "bfloat16"), summed in float32.  The tensor cores sum in
// their own order, so a sum can differ from the twin's in its last bits
// (about 1e-6 here).  Two places cannot take that:
// - The bf16 rounding of h1 and h2.  An h that lies near the midpoint
//   between its two bf16 neighbours can round the other way, and an h1 so
//   rounded moves all 64 h2 of its sample, its ratio and value by up to a
//   few 1e-3: enough to move a gradient entry beyond K3's tolerance on a
//   16,384-sample minibatch.  So an h within kTie of a midpoint (most of
//   them small, where the bf16 neighbours lie close) is recomputed in the
//   twin's order, an FMA chain over the layer's inputs (fix_midpoints, each
//   lane its own, all lanes at once), and the bf16 h1 and h2 are the
//   twin's.
// - The loss's decisions are knife edges: a sample whose ratio crosses 1 +-
//   clip_eps, or whose value crosses the value clip or the tie of its two
//   squared errors, changes the gradient by a whole sample's term.  So the
//   loss takes them from the twin's own forward: a sample whose ratio or
//   value lies within kEdge of one has its tower's h2 and head recomputed
//   in the twin's order from its h1 row (exact_head, the warp together)
//   and its loss taken again.
// What is left is the heads' and the products' order of summation, a few
// ulps.  The (1 - h^2) factors and the elementwise loss are rounded one
// operation at a time, as the twin rounds them.

// Shared memory (bf16 rows padded by 8 elements so that the 8 rows of an
// ldmatrix fall on 8 distinct 4-bank groups): the weights 28 KiB, the obs
// (two buffers) 6 KiB, h1, h2, dpre2, dpre1 17 KiB each, dout 6 KiB, and
// the float32 biases, staged inputs, head outputs, per-sample terms, bias
// partials and the exact head's h2 19 KiB: 130,320 bytes at D = 10, A = 4
// (the float32 body takes 215-221 KiB), of 232,448.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "ppo_loss_body.cuh"

namespace reinmav {
namespace ppo_loss_bf16 {

namespace ac = reinmav::ac;
using ppo_loss::LossCfg;

constexpr int kH = ac::H;
constexpr int kS = 64;                      // samples a sub-block
constexpr int kThreads = ppo_loss::kThreads;  // 8 warps
constexpr int kAP = 2 * kH + 8;             // activation rows (sample, fused unit): 136 bf16
constexpr int kWP = kH + 8;                 // weight rows: 72 bf16
constexpr int kXP = 16 + 8;                 // obs and dout rows: 24 bf16
constexpr int kRP = kS + 4;                 // float rows over the samples
// How close to a decision of the loss (the ratio clip, the value clip, the
// tie of the two squared errors) a sample's ratio or value may lie before
// its h2 and head are recomputed in the twin's order: far above the
// heads' own differences from the twin's (a few ulps), and above what a
// bf16 h2 rounded the other way would move them (5e-4 at most), should
// one pass fix_midpoints' test.
constexpr float kEdge = 1.0f / 1024;
// How close an h may lie to the midpoint between its two bf16 neighbours
// before it is recomputed in the twin's order: above the difference
// between the tensor cores' sum and the twin's FMA chain (K <= 64 products
// of bf16 operands, each exact in float32; a few 1e-7).
constexpr float kTie = 1.0f / (1 << 20);
static_assert(kThreads == 256 && kH == 64, "the warp layout assumes 8 warps and 64 units");

using bf16 = __nv_bfloat16;

template <int kD, int kA>
struct Smem {
  static_assert(kD <= 16 && kA + 1 <= 8, "L1 takes one k16 step, the heads one n8 tile");
  static constexpr int kIn = kA + 4;       // staged per sample: action, old logp, old value, adv, ret
  static constexpr int kTerms = 2 * kA + 5;  // dmean (A), dvalue, dls (A), pg, v, kl, clipfrac
  alignas(16) bf16 w1[2][16][kWP];   // (tower, in, out); rows D..15 zero
  alignas(16) bf16 w2[2][kH][kWP];   // (tower, in, out)
  alignas(16) bf16 wo[2][kH][kXP];   // (tower, unit, head column): wpi in columns 0..A-1, wvf in 0
  alignas(16) bf16 x[2][kS][kXP];    // two buffers of (sample, obs); columns D..15 zero
  alignas(16) bf16 h1[kS][kAP];      // (sample, fused unit), fused unit = tower * 64 + unit
  alignas(16) bf16 h2[kS][kAP];
  alignas(16) bf16 dp2[kS][kAP];
  alignas(16) bf16 dp1[kS][kAP];
  alignas(16) bf16 dout[2][kS][kXP];  // (tower, sample, head column); unused columns zero
  float b1[2][kH];
  float b2[2][kH];
  float bo[kA + 1];
  float ls[kA];
  float var[kA];             // exp(2 log_std)
  float in[2][kIn][kRP];     // two buffers of the staged per-sample inputs
  float head[2][kS][8];      // (tower, sample, column): the heads before their bias
  float terms[kTerms][kRP];  // per-sample float32 terms of the per-sample sums
  float bsum[2][2][4][kH];   // (db1 or db2, tower, sample warp, unit): the warps' bias sums
  float xh[8][kH];           // each warp's h2 of the sample exact_head recomputes
};

// K4's 256 floats of block scratch between two runs of the body.
template <int kD, int kA>
__device__ __forceinline__ float* scratch(Smem<kD, kA>& sm) {
  return &sm.bsum[0][0][0][0];
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ldmatrix of four (or two) 8 x 8 bf16 matrices, lane l giving the address
// of a row of matrix l / 8; .trans hands each thread the transpose's entry.
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

__device__ __forceinline__ void ldsm4t(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

__device__ __forceinline__ void ldsm2t(uint32_t (&r)[2], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p))
               : "memory");
}

// c += a b: a the m16k16 A fragment, (b0, b1) the k16n8 B fragment, c the
// m16n8 float32 accumulator.
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats rounded to bf16 (round to nearest even), lo in the low half.
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ void st_pair(bf16* p, uint32_t v) { *reinterpret_cast<uint32_t*>(p) = v; }

// The row and column offsets a lane gives ldmatrix.x4 for an m16k16 A
// fragment from (m, k) rows, or two n8 B fragments from (k, n) rows with
// .trans: rows + lane % 16, columns + 8 (lane / 16).
__device__ __forceinline__ int row_a(int lane) { return lane & 15; }
__device__ __forceinline__ int col_a(int lane) { return (lane >> 4) << 3; }
// ... for an A fragment from (k, m) rows with .trans, or two B fragments
// from (n, k) rows: rows + lane % 8 + 8 (lane / 16), columns + 8 (lane / 8 % 2).
__device__ __forceinline__ int row_t(int lane) { return (lane & 7) + ((lane >> 4) << 3); }
__device__ __forceinline__ int col_t(int lane) { return ((lane >> 3) & 1) << 3; }

// The weights of the flat vector `net` into shared memory, rounded to bf16
// once (the biases and the log-std stay float32), the padding zeroed.
// Loads through L2 (__ldcg): in K4 other CTAs rewrite the vector between
// passes.  The caller synchronises the block before the body reads them.
template <int kD, int kA>
__device__ __forceinline__ void load_weights(Smem<kD, kA>& sm, const float* net) {
  using L = ac::Layout<kD, kA>;
  const int tid = threadIdx.x;
  for (int idx = tid; idx < 16 * kH; idx += kThreads) {
    const int d = idx / kH, j = idx % kH;
    for (int t = 0; t < 2; ++t) {
      sm.w1[t][d][j] = __float2bfloat16_rn(d < kD ? __ldcg(net + L::tower_base(t) + L::kW1 + idx) : 0.0f);
    }
  }
  for (int idx = tid; idx < kH * kH; idx += kThreads) {
    const int k = idx / kH, j = idx % kH;
    for (int t = 0; t < 2; ++t) {
      sm.w2[t][k][j] = __float2bfloat16_rn(__ldcg(net + L::tower_base(t) + L::kW2 + idx));
    }
  }
  for (int idx = tid; idx < kH * 16; idx += kThreads) {
    const int j = idx / 16, c = idx % 16;
    sm.wo[0][j][c] = __float2bfloat16_rn(c < kA ? __ldcg(net + L::kPiOutW + j * kA + c) : 0.0f);
    sm.wo[1][j][c] = __float2bfloat16_rn(c == 0 ? __ldcg(net + L::kVfOutW + j) : 0.0f);
  }
  for (int j = tid; j < kH; j += kThreads) {
    for (int t = 0; t < 2; ++t) {
      sm.b1[t][j] = __ldcg(net + L::tower_base(t) + L::kB1 + j);
      sm.b2[t][j] = __ldcg(net + L::tower_base(t) + L::kB2 + j);
    }
  }
  if (tid < kA) {
    sm.bo[tid] = __ldcg(net + L::kPiOutB + tid);
    sm.ls[tid] = __ldcg(net + L::kLogStd + tid);
    sm.var[tid] = expf(2.0f * sm.ls[tid]);
  }
  if (tid == kA) sm.bo[kA] = __ldcg(net + L::kVfOutB);
}

// Whether v lies within kTie of the midpoint between its two bf16
// neighbours, where another order of summation can round it the other way.
__device__ __forceinline__ bool near_midpoint(float v) {
  const float mid = __uint_as_float((__float_as_uint(v) & 0xffff0000u) | 0x8000u);
  return fabsf(v - mid) <= kTie;
}

// A layer's outputs that lie within kTie of a bf16 midpoint (c, the
// accumulators of the warp's 16 rows from s0 and its tower's 64 units
// from u0), recomputed in the twin's order by unit(row, column) and
// stored, rounded to bf16, into the layer's rows; then the layer's A
// fragments reloaded from the rows.  Each lane recomputes its own outputs,
// all lanes at once; the float32 values in c stay as they are.
template <class Unit>
__device__ __forceinline__ void fix_midpoints(const float (&c)[8][4], bf16 (*rows)[kAP], int s0,
                                              int u0, int lane, uint32_t (&a)[4][4], Unit&& unit) {
  uint32_t near = 0;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
    for (int i = 0; i < 4; ++i) near |= static_cast<uint32_t>(near_midpoint(c[nt][i])) << (4 * nt + i);
  }
  if (!__any_sync(0xffffffffu, near != 0)) return;
  const int g = lane >> 2, q = lane & 3;
  for (; near != 0; near &= near - 1) {
    const int slot = __ffs(near) - 1;  // 4 nt + i
    const int row = s0 + g + 8 * ((slot >> 1) & 1), col = 8 * (slot >> 2) + 2 * q + (slot & 1);
    rows[row][u0 + col] = __float2bfloat16_rn(unit(row, col));
  }
  __syncwarp();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) ldsm4(a[kk], &rows[s0 + row_a(lane)][u0 + 16 * kk + col_a(lane)]);
}

// acc (an m16n8 accumulator of rows g, g + 8 and columns 2q, 2q + 1)
// plus the bias b[column], through tanhf, in place.
__device__ __forceinline__ void bias_tanh(float (&c)[4], const float* b) {
  c[0] = tanhf(c[0] + b[0]);
  c[1] = tanhf(c[1] + b[1]);
  c[2] = tanhf(c[2] + b[0]);
  c[3] = tanhf(c[3] + b[1]);
}

// The A fragments of a 16 x 64 float32 block held as eight m16n8
// accumulators (k16 step kk = accumulators 2 kk, 2 kk + 1), rounded to bf16;
// the same block stored to the bf16 rows `row0` (row g) and `row8` (row g
// + 8) at column 2q of each n8 tile.
__device__ __forceinline__ void pack_rows(const float (&c)[8][4], uint32_t (&a)[4][4], bf16* row0,
                                          bf16* row8) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float(&t)[4] = c[2 * kk + h];
      a[kk][2 * h] = pack(t[0], t[1]);
      a[kk][2 * h + 1] = pack(t[2], t[3]);
      st_pair(row0 + 8 * (2 * kk + h), a[kk][2 * h]);
      st_pair(row8 + 8 * (2 * kk + h), a[kk][2 * h + 1]);
    }
  }
}

// The float32 sums over the warp's 16 rows of each column of a 16 x 64
// block held as eight m16n8 accumulators, written by lanes 0-3 to out[64]
// (two rows a thread, then the 8 row groups by shuffles, in a fixed order).
__device__ __forceinline__ void column_sums(const float (&c)[8][4], float* out, int lane) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    float s0 = c[nt][0] + c[nt][2], s1 = c[nt][1] + c[nt][3];
#pragma unroll
    for (int off = 4; off < 32; off <<= 1) {
      s0 += __shfl_xor_sync(0xffffffffu, s0, off);
      s1 += __shfl_xor_sync(0xffffffffu, s1, off);
    }
    if (lane < 4) {
      out[8 * nt + 2 * lane] = s0;
      out[8 * nt + 2 * lane + 1] = s1;
    }
  }
}

// The twin's h2 unit `col` of tower tw from a sample's bf16 h1 row: an FMA
// chain from 0 over the units in order, then the bias and tanhf (the twin's
// float32 matmul on bf16 operands, chip_smoke.py's forward-order probe).
template <int kD, int kA>
__device__ __forceinline__ float l2_unit(const Smem<kD, kA>& sm, int tw, const bf16* h1, int col) {
  float a = 0.0f;
#pragma unroll
  for (int k0 = 0; k0 < kH; k0 += 8) {
    const uint4 hv = *reinterpret_cast<const uint4*>(h1 + k0);  // 8 units of the row at once
    const uint32_t w[4] = {hv.x, hv.y, hv.z, hv.w};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float hk = __uint_as_float(j & 1 ? w[j >> 1] & 0xffff0000u : w[j >> 1] << 16);
      a = fmaf(hk, __bfloat162float(sm.w2[tw][k0 + j][col]), a);
    }
  }
  return tanhf(a + sm.b2[tw][col]);
}

// The head of sample s of tower tw (before its bias) as the twin computes
// it, into sm.head[tw][s]: its h2 from its h1 row (l2_unit, two units a
// lane, into sm.xh[warp]), then the mean head an FMA chain from 0 over the
// units in order, or the value head's products and sums rounded apart in
// unit order (ops/ppo_loss.py::value_head).  The whole warp takes part.
template <int kD, int kA>
__device__ __forceinline__ void exact_head(Smem<kD, kA>& sm, int tw, int s, int lane) {
  float* h = sm.xh[threadIdx.x >> 5];
  const auto r = [](float v) { return __bfloat162float(__float2bfloat16_rn(v)); };
  const bf16* h1 = &sm.h1[s][tw * kH];
  __syncwarp();  // the previous sample's head has read h
  h[lane] = r(l2_unit(sm, tw, h1, lane));
  h[lane + 32] = r(l2_unit(sm, tw, h1, lane + 32));
  __syncwarp();
  if (tw == 0) {
    if (lane < kA) {
      float m = 0.0f;
      for (int j = 0; j < kH; ++j) m = fmaf(h[j], __bfloat162float(sm.wo[0][j][lane]), m);
      sm.head[0][s][lane] = m;
    }
  } else if (lane == 0) {
    float v = 0.0f;
    for (int j = 0; j < kH; ++j) v = __fadd_rn(v, __fmul_rn(h[j], __bfloat162float(sm.wo[1][j][0])));
    sm.head[1][s][0] = v;
  }
}

// The loss gradient over the sub-blocks of 64 samples blockIdx.x,
// blockIdx.x + gridDim.x, ... of the minibatch of `mb` samples defined by
// `perm`, with the weights already in `sm` (load_weights).  Writes the
// CTA's raw sums (ppo_loss::out_size<kD, kA>() floats, each by exactly one
// thread) to `out`.  Its last accesses to shared memory are not followed by
// a block synchronisation: the caller synchronises before it reuses it.
// kProbe (a separate kernel, never the main path's): each minibatch sample
// q's ratio and value from the tensor cores' forward to probe[4 q], probe[4 q
// + 1], and as the loss finally takes them (the twin's own for a sample
// near a decision) to probe[4 q + 2], probe[4 q + 3].
template <int kD, int kA, bool kKl, bool kProbe = false>
__device__ __forceinline__ void loss_body(Smem<kD, kA>& sm, const float* __restrict__ data, int64_t n,
                                          const int* __restrict__ perm, int64_t mb, int tile,
                                          float adv_shift, float adv_inv, float kl_beta,
                                          const LossCfg& cfg, float* __restrict__ out,
                                          float* __restrict__ probe = nullptr) {
  using L = ac::Layout<kD, kA>;
  using Sm = Smem<kD, kA>;
  constexpr int kR = kD + Sm::kIn;        // rows of the stacked batch
  constexpr int kPre = (kR + 3) / 4;      // rows a thread gathers: 4 threads a sample
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int tw = warp >> 2;      // tower of the warp
  const int mt = warp & 3;       // the chain's 16 samples; the weight gradients' quarter
  const int s0 = 16 * mt;
  const int u0 = tw * kH;        // the tower's first fused unit

  // The padding the products read: obs columns D..15, dout's unused columns.
  for (int i = tid; i < 2 * kS * 16; i += kThreads) {
    const int b = i / (kS * 16), s = (i / 16) % kS, c = i % 16;
    if (c >= kD) sm.x[b][s][c] = __float2bfloat16_rn(0.0f);
    sm.dout[b][s][c] = __float2bfloat16_rn(0.0f);
  }

  // Weight-gradient accumulators, summed over all the CTA's sub-blocks.
  float g_w2[2][4][4] = {};  // dW2[tw][32 (mt / 2) + 16 i + g (+8)][32 (mt % 2) + 8 j + 2q (+1)]
  float g_w1[2][4] = {};     // dW1[tw][g (+8)][16 mt + 8 j + 2q (+1)]
  float g_wo[4] = {};        // dW_out[tw][16 mt + g (+8)][2q (+1)]
  float g_b = 0.0f;          // threads 0-127: db1[fused unit tid]; 128-255: db2[fused unit tid - 128]
  float g_red = 0.0f;        // tid < 2 A + 5: the per-sample sum of terms row tid

  // ---- P0: a sub-block's inputs, gathered into registers (4 threads a
  // sample, rows r = tid / 64 + 4 i) and staged: the obs as bf16 into x,
  // the rest float32 into in.
  const int gs = tid & (kS - 1), gr = tid >> 6;
  float pre[kPre];
  auto fetch = [&](int64_t b) {
    const int64_t qb = b * kS + gs;
    const bool ok = qb < mb;
    int64_t col = 0;
    if (ok) col = static_cast<int64_t>(perm[qb / tile]) * tile + qb % tile;
#pragma unroll
    for (int i = 0; i < kPre; ++i) {
      const int r = gr + 4 * i;
      pre[i] = ok && r < kR ? data[r * n + col] : 0.0f;
    }
  };
  auto stage = [&](int buf) {
#pragma unroll
    for (int i = 0; i < kPre; ++i) {
      const int r = gr + 4 * i;
      if (r < kD) {
        sm.x[buf][gs][r] = __float2bfloat16_rn(pre[i]);
      } else if (r < kR) {
        sm.in[buf][r - kD][gs] = pre[i];
      }
    }
  };
  fetch(blockIdx.x);
  stage(0);

  const int64_t n_sub = (mb + kS - 1) / kS;
  int buf = 0;
  for (int64_t blk = blockIdx.x; blk < n_sub; blk += gridDim.x, buf ^= 1) {
    __syncthreads();  // the staged inputs; the last sub-block's readers are done
    fetch(blk + gridDim.x);

    // ---- P1: the warp's chain, forward: L1, L2 and its head ------------
    float hf1[8][4], hf2[8][4];
    uint32_t fa[4][4];  // A fragments: h1, then h2, then dpre2 (bf16)
    {
      uint32_t xa[4];
      ldsm4(xa, &sm.x[buf][s0 + row_a(lane)][col_a(lane)]);
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        uint32_t b[4];
        ldsm4t(b, &sm.w1[tw][row_a(lane)][16 * p + col_a(lane)]);
#pragma unroll
        for (int i = 0; i < 4; ++i) hf1[2 * p][i] = hf1[2 * p + 1][i] = 0.0f;
        mma(hf1[2 * p], xa, b[0], b[1]);
        mma(hf1[2 * p + 1], xa, b[2], b[3]);
      }
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) bias_tanh(hf1[nt], &sm.b1[tw][8 * nt + 2 * q]);
      pack_rows(hf1, fa, &sm.h1[s0 + g][u0 + 2 * q], &sm.h1[s0 + g + 8][u0 + 2 * q]);
      fix_midpoints(hf1, sm.h1, s0, u0, lane, fa, [&](int row, int col) {
        float a = 0.0f;
#pragma unroll
        for (int d = 0; d < kD; ++d) {
          a = fmaf(__bfloat162float(sm.x[buf][row][d]), __bfloat162float(sm.w1[tw][d][col]), a);
        }
        return tanhf(a + sm.b1[tw][col]);
      });
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) hf2[nt][i] = 0.0f;
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        uint32_t b[4];
        ldsm4t(b, &sm.w2[tw][16 * kk + row_a(lane)][16 * p + col_a(lane)]);
        mma(hf2[2 * p], fa[kk], b[0], b[1]);
        mma(hf2[2 * p + 1], fa[kk], b[2], b[3]);
      }
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) bias_tanh(hf2[nt], &sm.b2[tw][8 * nt + 2 * q]);
    pack_rows(hf2, fa, &sm.h2[s0 + g][u0 + 2 * q], &sm.h2[s0 + g + 8][u0 + 2 * q]);
    fix_midpoints(hf2, sm.h2, s0, u0, lane, fa, [&](int row, int col) {
      return l2_unit(sm, tw, &sm.h1[row][u0], col);
    });
    {
      float hd[4] = {};
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t b[2];
        ldsm2t(b, &sm.wo[tw][16 * kk + row_a(lane)][0]);
        mma(hd, fa[kk], b[0], b[1]);
      }
      sm.head[tw][s0 + g][2 * q] = hd[0];
      sm.head[tw][s0 + g][2 * q + 1] = hd[1];
      sm.head[tw][s0 + g + 8][2 * q] = hd[2];
      sm.head[tw][s0 + g + 8][2 * q + 1] = hd[3];
    }
    __syncwarp();

    // The loss of sample s0 + lane from its head in sm.head; with `exact`
    // false, whether it lies within kEdge of a decision (the clipped
    // mode's ratio clip in tower 0, the value clip or the tie of the two
    // squared errors outside it in tower 1).
    auto loss = [&](bool exact) {
      bool edge = false;
      const int s = s0 + lane;
      const bool valid = blk * kS + s < mb;
      const float* in = &sm.in[buf][0][0];
      float* pr = kProbe ? probe + 4 * (blk * kS + s) : nullptr;
      if (tw == 0) {
        float dm[kA] = {}, dls[kA] = {};
        float pg = 0.0f, kl = 0.0f, clipped_out = 0.0f;
        if (valid) {
          float diff[kA], quad[kA], var[kA];
          // logp and the ratio rounded one operation at a time, in the
          // twin's order (ops/ppo_loss.py::logp_ratio).
          float qsum = 0.0f, ls_sum = 0.0f;
#pragma unroll
          for (int a = 0; a < kA; ++a) {
            var[a] = sm.var[a];
            diff[a] = __fsub_rn(in[a * kRP + s], sm.head[0][s][a] + sm.bo[a]);
            quad[a] = __fdiv_rn(__fmul_rn(diff[a], diff[a]), var[a]);
            qsum = __fadd_rn(qsum, quad[a]);
            ls_sum = __fadd_rn(ls_sum, sm.ls[a]);
          }
          const float old_logp = in[kA * kRP + s];
          const float adv = (in[(kA + 2) * kRP + s] - adv_shift) * adv_inv;
          const float logp = __fsub_rn(__fsub_rn(__fmul_rn(-0.5f, qsum), ls_sum),
                                       0.5f * kA * ac::kLog2Pi);
          const float ratio = expf(__fsub_rn(logp, old_logp));
          if constexpr (kProbe) {
            if (!exact) pr[0] = ratio;
            pr[2] = ratio;
          }
          kl = old_logp - logp;
          float dlogp;
          if (kKl) {
            dlogp = -ratio * adv - kl_beta;
            pg = -(ratio * adv) + kl_beta * kl;
          } else {
            edge = fabsf(ratio - (1.0f - cfg.clip_eps)) <= kEdge ||
                   fabsf(ratio - (1.0f + cfg.clip_eps)) <= kEdge;
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
          clipped_out = fabsf(ratio - 1.0f) > cfg.clip_eps ? 1.0f : 0.0f;
#pragma unroll
          for (int a = 0; a < kA; ++a) {
            dm[a] = dlogp * (diff[a] / var[a]);
            dls[a] = dlogp * (quad[a] - 1.0f);
          }
        }
#pragma unroll
        for (int a = 0; a < kA; ++a) {
          sm.terms[a][s] = dm[a];
          sm.terms[kA + 1 + a][s] = dls[a];
          sm.dout[0][s][a] = __float2bfloat16_rn(dm[a]);
        }
        sm.terms[2 * kA + 1][s] = pg;
        sm.terms[2 * kA + 3][s] = kl;
        sm.terms[2 * kA + 4][s] = clipped_out;
      } else {
        float dv = 0.0f, vl = 0.0f;
        if (valid) {
          const float value = sm.head[1][s][0] + sm.bo[kA];
          if constexpr (kProbe) {
            if (!exact) pr[1] = value;
            pr[3] = value;
          }
          const float old_value = in[(kA + 1) * kRP + s];
          const float ret = in[(kA + 3) * kRP + s];
          const float vdiff = value - old_value;
          const float vcl =
              old_value + fminf(fmaxf(vdiff, -cfg.value_clip_eps), cfg.value_clip_eps);
          const float e1 = value - ret, e2 = vcl - ret;
          const float sq1 = e1 * e1, sq2 = e2 * e2;
          edge = fabsf(fabsf(vdiff) - cfg.value_clip_eps) <= kEdge ||
                 (fabsf(vdiff) >= cfg.value_clip_eps && fabsf(e1 + e2) <= kEdge);
          const float vin = fabsf(vdiff) < cfg.value_clip_eps ? 1.0f : 0.0f;
          const float vs1 = sq1 > sq2 ? 1.0f : 0.0f;
          const float vs2 = sq2 > sq1 ? 1.0f : 0.0f;
          const float vtie = 1.0f - vs1 - vs2;
          dv = cfg.value_coef * (vs1 * e1 + vs2 * e2 * vin + 0.5f * vtie * (e1 + e2 * vin));
          vl = 0.5f * fmaxf(sq1, sq2);
        }
        sm.terms[kA][s] = dv;
        sm.terms[2 * kA + 2][s] = vl;
        sm.dout[1][s][0] = __float2bfloat16_rn(dv);
      }
      return edge && !exact;
    };
    // ---- P2: the tower's loss terms and cotangent, a sample a lane.  The
    // decisions (the ratio clip, the value clip and its tie) are the twin's:
    // a sample whose forward lies within kEdge of one is recomputed in the
    // twin's own order (exact_head) and its loss taken again from that.
    bool near = false;
    if (lane < 16) near = loss(false);
    const unsigned redo = __ballot_sync(0xffffffffu, near);
    if (redo != 0) {
      for (unsigned m = redo; m != 0; m &= m - 1) exact_head(sm, tw, s0 + __ffs(m) - 1, lane);
      __syncwarp();
      if ((redo >> lane) & 1u) loss(true);
    }
    __syncwarp();

    // ---- P3: the warp's chain, backward: dh2, dpre2, dpre1 --------------
    {
      uint32_t da[4];
      ldsm4(da, &sm.dout[tw][s0 + row_a(lane)][col_a(lane)]);
      float acc[8][4];
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        uint32_t b[4];
        ldsm4(b, &sm.wo[tw][16 * p + row_t(lane)][col_t(lane)]);
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[2 * p][i] = acc[2 * p + 1][i] = 0.0f;
        mma(acc[2 * p], da, b[0], b[1]);
        mma(acc[2 * p + 1], da, b[2], b[3]);
      }
      // dpre2 = dh2 (1 - h2^2), rounded as the twin's three operations.
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[nt][i] = __fmul_rn(acc[nt][i], __fsub_rn(1.0f, __fmul_rn(hf2[nt][i], hf2[nt][i])));
        }
      }
      pack_rows(acc, fa, &sm.dp2[s0 + g][u0 + 2 * q], &sm.dp2[s0 + g + 8][u0 + 2 * q]);
      column_sums(acc, &sm.bsum[1][tw][mt][0], lane);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[nt][i] = 0.0f;
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          uint32_t b[4];
          ldsm4(b, &sm.w2[tw][16 * p + row_t(lane)][16 * kk + col_t(lane)]);
          mma(acc[2 * p], fa[kk], b[0], b[1]);
          mma(acc[2 * p + 1], fa[kk], b[2], b[3]);
        }
      }
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[nt][i] = __fmul_rn(acc[nt][i], __fsub_rn(1.0f, __fmul_rn(hf1[nt][i], hf1[nt][i])));
        }
      }
      pack_rows(acc, fa, &sm.dp1[s0 + g][u0 + 2 * q], &sm.dp1[s0 + g + 8][u0 + 2 * q]);
      column_sums(acc, &sm.bsum[0][tw][mt][0], lane);
    }
    __syncthreads();

    // ---- P4: the weight gradients over the sub-block's 64 samples ------
    {
      const int k0 = u0 + 32 * (mt >> 1), j0 = u0 + 32 * (mt & 1);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const int sr = 16 * kk;
        uint32_t a0[4], a1[4], b[4];
        ldsm4t(a0, &sm.h1[sr + row_t(lane)][k0 + col_t(lane)]);
        ldsm4t(a1, &sm.h1[sr + row_t(lane)][k0 + 16 + col_t(lane)]);
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          ldsm4t(b, &sm.dp2[sr + row_a(lane)][j0 + 16 * p + col_a(lane)]);
          mma(g_w2[0][2 * p], a0, b[0], b[1]);
          mma(g_w2[0][2 * p + 1], a0, b[2], b[3]);
          mma(g_w2[1][2 * p], a1, b[0], b[1]);
          mma(g_w2[1][2 * p + 1], a1, b[2], b[3]);
        }
        ldsm4t(a0, &sm.x[buf][sr + row_t(lane)][col_t(lane)]);
        ldsm4t(b, &sm.dp1[sr + row_a(lane)][u0 + 16 * mt + col_a(lane)]);
        mma(g_w1[0], a0, b[0], b[1]);
        mma(g_w1[1], a0, b[2], b[3]);
        uint32_t bo[2];
        ldsm4t(a1, &sm.h2[sr + row_t(lane)][u0 + 16 * mt + col_t(lane)]);
        ldsm2t(bo, &sm.dout[tw][sr + row_a(lane)][0]);
        mma(g_wo, a1, bo[0], bo[1]);
      }
      // The bias sums: over the tower's 4 sample warps in order.
      const float* bs = &sm.bsum[tid >> 7][(tid >> 6) & 1][0][tid & (kH - 1)];
#pragma unroll
      for (int w = 0; w < 4; ++w) g_b += bs[w * kH];
      if (tid < Sm::kTerms) {
        const float* row = sm.terms[tid];
        for (int s = 0; s < kS; ++s) g_red += row[s];
      }
    }
    stage(buf ^ 1);
  }

  // ---- this CTA's partial sums, each entry written by exactly one thread --
  {
    const int base = L::tower_base(tw);
    const int k0 = 32 * (mt >> 1), j0 = 32 * (mt & 1);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k = k0 + 16 * i + g, c = j0 + 8 * j + 2 * q;
        float* w2 = out + base + L::kW2;
        w2[k * kH + c] = g_w2[i][j][0];
        w2[k * kH + c + 1] = g_w2[i][j][1];
        w2[(k + 8) * kH + c] = g_w2[i][j][2];
        w2[(k + 8) * kH + c + 1] = g_w2[i][j][3];
      }
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int c = 16 * mt + 8 * j + 2 * q;
      float* w1 = out + base + L::kW1;
      if (g < kD) {
        w1[g * kH + c] = g_w1[j][0];
        w1[g * kH + c + 1] = g_w1[j][1];
      }
      if (g + 8 < kD) {
        w1[(g + 8) * kH + c] = g_w1[j][2];
        w1[(g + 8) * kH + c + 1] = g_w1[j][3];
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int j = 16 * mt + g + 8 * r;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int a = 2 * q + c;
        if (tw == 0 && a < kA) out[L::kPiOutW + j * kA + a] = g_wo[2 * r + c];
        if (tw == 1 && a == 0) out[L::kVfOutW + j] = g_wo[2 * r + c];
      }
    }
    const int fu = tid & (2 * kH - 1);  // fused unit of the bias entry
    out[L::tower_base(fu / kH) + (tid < 2 * kH ? L::kB1 : L::kB2) + fu % kH] = g_b;
  }
  if (tid < kA) {
    out[L::kPiOutB + tid] = g_red;
  } else if (tid == kA) {
    out[L::kVfOutB] = g_red;
  } else if (tid < 2 * kA + 1) {
    out[L::kLogStd + tid - kA - 1] = g_red;
  } else if (tid < Smem<kD, kA>::kTerms) {
    out[L::kNetSize + tid - 2 * kA - 1] = g_red;
  }
}

}  // namespace ppo_loss_bf16
}  // namespace reinmav
