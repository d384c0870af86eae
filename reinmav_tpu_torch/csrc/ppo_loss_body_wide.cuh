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
// minibatch in the flat parameter layout (actor_critic.cuh::RtLayout), then
// the 4 metric sums.  Its twin is ops/ppo_loss.py::ppo_loss_grads_reference.
//
// What bounds it: the products, 6 H^2 + 4 D H multiply-adds a sample (the
// two towers' forward, dpre1 = dpre2 W2^T and dW2; 8.2e5 operations a sample
// at H = 256, D = 10), and the 4 H tanhf a sample on the SFUs.  The first
// wide body ran the products as FP32 FMAs over weight rows staged through
// shared memory behind barriers every 32 samples, and summed the weight
// gradient into the CTA's row of partial sums in global memory every 32
// samples: a clock64 probe of it put 43% of a sub-block's cycles in the
// weight staging and 27% in that round trip (NVIDIA H100 80GB HBM3, 700 W).
//
// Design:
// - One tower a CTA.  The towers are independent up to the loss: the
//   policy terms (ratio, surrogate, log-std, KL) read only tower 0's mean,
//   the value terms only tower 1's value.  CTA b takes tower b % 2; the
//   CTAs of a tower take its sub-blocks of kS = 64 samples in turn.
// - The products on the tensor cores with mma.sync: bf16 m16n8k16 (the
//   twin's bf16_mm: exact products of bf16 operands summed in float32), and
//   in float32 m16n8k8 tf32 as 3xTF32: each operand split as hi =
//   cvt.rna.tf32(x) and lo = cvt.rna.tf32(x - hi), and lo hi + hi lo + hi
//   hi summed into the float32 accumulators (the lo lo term, 2^-22 of a
//   product, dropped).  Against the float64 twin at H = 256, (10, 4), a
//   262,144-sample minibatch (chip_smoke.py --only wide, NVIDIA H100 80GB
//   HBM3, 700 W): the largest gradient error 3.1e-7, 0.023 of the gate's
//   2e-6 + 2e-3 |g|; hi hi alone (1xTF32, csrc_probe/) 4.1e-5, 9.6 times
//   it, 327 entries outside the gate.
// - The weights are read as mma fragments from global memory (L2), copied
//   a k-step ahead into a ring of the warp's own (cp.async), in a packed
//   layout (pack_entry) that gives a lane its fragment in one 16-byte word:
//   W1 and W2 for the forward, W2 transposed for dpre1; in float32 already
//   split into tf32 hi and lo planes, so that only the activations are
//   split as they are read.  They are packed once a launch (K3) or as Adam
//   writes them (K4), not staged every sub-block.  The activations of a
//   sub-block stay in shared memory as [unit][sample] rows.
// - The weight gradient in two phases.  Phase A, per sub-block: forward,
//   heads, loss, dpre2, dpre1; the operands of dW1 and dW2 (x, h1, dpre2,
//   dpre1, bf16 in the bf16 instance) go to the CTA's panels in global
//   memory, in the same packed fragment layout.  Phase B, after the CTA's
//   last sub-block: dW2 = h1^T dpre2 and dW1 = x^T dpre1 as products over
//   all the CTA's samples, each warp's 64 x 16 tile of the gradient held
//   in registers over them, written once to the CTA's partial row.  The
//   heads' gradients, the bias gradients, log-std and the metrics are
//   summed per sample into registers of the thread that owns the entry,
//   over all the CTA's sub-blocks, and written once too.  No atomics: a
//   rerun is bitwise equal.
// - The heads and the loss: the mean head on every thread (sample, action),
//   the value head on a thread a sample (its rounding is one product and
//   one sum at a time, in j order), the loss on a thread a sample.
// - bf16 rounding of h1 and h2: the tensor cores sum in their own order, so
//   an h within tie(h) = 2^-19 + 2^-18 |h| of a bf16 midpoint could round
//   the other way from the twin's.  Such an h is recomputed in the twin's
//   order, an FMA chain from 0 over the layer's inputs with the bias added
//   last, by a thread of the CTA (queued in shared memory), and counted.
//
// The orders that decide a knife edge stay the 64 body's and the twin's:
// the mean head an FMA chain from 0 in j order, the value head one product
// and one sum at a time, logp and the ratio one operation at a time.
//
// A CTA's partial row holds only the entries its tower owns
// (owner_tower): the caller adds, for each entry, the rows of its tower's
// CTAs in block order.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "actor_critic.cuh"
#include "bf16_round.cuh"

namespace reinmav {
namespace ppo_wide {

namespace ac = reinmav::ac;
using reinmav::bf16r;

constexpr int kThreads = 512;
constexpr int kMaxHidden = 256;
constexpr int kMaxObs = 32;
constexpr int kMaxAction = 8;
constexpr int kS = 64;              // samples a sub-block
constexpr int kMT = kS / 16;        // m16 tiles of a sub-block
constexpr int kRecCap = 1024;       // bf16: h's queued for a recompute, a layer
constexpr int kWarps = kThreads / 32;
constexpr int kDepthA = 2;          // k-steps phase A's copies run ahead, plus 1
constexpr int kRingA = kDepthA * 2 * 32;  // 16-byte words of a warp's phase A ring
// Phase B's stages: kStageK k-steps of a CTA tile's 8 A and 8 B blocks of
// 32 16-byte words each, kStages of them in flight (the whole area from 0).
constexpr int kStageK = 4;
constexpr int kStages = 3;
constexpr int kStageWords = kStageK * 16 * 32;
constexpr int kSmemLimit = 232448;  // a block's dynamic shared memory on sm_90
// Register accumulators a thread for the entries summed per sample (the
// heads' gradients, dbo, log-std, the metrics, db1, db2): at most H A + 2 A
// + 3 + 2 H = 2579 entries a tower, 512 threads.
constexpr int kSmall = 6;
constexpr float kTieAbs = 1.0f / (1 << 19);
constexpr float kTieRel = 1.0f / (1 << 18);

// 1xTF32, a numerics control (csrc_probe/ppo_loss_wide_1xtf32.cu defines
// REINMAV_WIDE_ONE_TF32 1; the kernel library never does): the float32
// products as hi hi alone, to show what the lo terms of 3xTF32 buy.
#ifndef REINMAV_WIDE_ONE_TF32
#define REINMAV_WIDE_ONE_TF32 0
#endif

// The phase probe (csrc_probe/ppo_loss_wide_probe.cu defines
// REINMAV_WIDE_PROBE 1; the kernel library never does): thread 0 of each
// CTA reads clock64 at the body's phase boundaries and adds the cycles
// since its last mark to the phase's counter, its waits at the barriers to
// kPhBarrier; the counters go to g_wide_probe (kProbePhases a CTA).  With
// g_wide_miss set, the bf16 instance also runs the twin's chain for every
// h of a real unit and counts in g_wide_miss [h1 checked, h1 recomputed,
// h1 missed, the same for h2, then h1 farther than a quarter of the window
// from its chain, than half of it, the same for h2] those it recomputed,
// those whose bf16 rounding the window missed, and how far the tensor
// cores' h's lie from the twin's.
#ifndef REINMAV_WIDE_PROBE
#define REINMAV_WIDE_PROBE 0
#endif
enum ProbePhase {
  kPhGather, kPhFwdProducts, kPhRecompute, kPhHeadsLoss, kPhHeadGrads, kPhDpre2,
  kPhDpreProducts, kPhPanels, kPhWgrad, kPhBarrier, kProbePhases
};
#if REINMAV_WIDE_PROBE
__device__ unsigned long long* g_wide_probe;
__device__ unsigned long long* g_wide_miss;
__device__ __forceinline__ unsigned long long* probe_acc() {
  __shared__ unsigned long long acc[kProbePhases + 1];  // the last: the clock at the last mark
  return acc;
}
__device__ __forceinline__ void probe_start() {
  if (threadIdx.x == 0) {
    unsigned long long* a = probe_acc();
    for (int i = 0; i < kProbePhases; ++i) a[i] = 0;
    a[kProbePhases] = clock64();
  }
}
__device__ __forceinline__ void probe_mark(int phase) {
  if (threadIdx.x == 0) {
    unsigned long long* a = probe_acc();
    const unsigned long long now = clock64();
    a[phase] += now - a[kProbePhases];
    a[kProbePhases] = now;
  }
}
__device__ __forceinline__ void probe_sync(int phase) {
  probe_mark(phase);
  __syncthreads();
  probe_mark(kPhBarrier);
}
__device__ __forceinline__ void probe_flush() {
  if (threadIdx.x == 0 && g_wide_probe != nullptr) {
    for (int i = 0; i < kProbePhases; ++i) {
      g_wide_probe[blockIdx.x * kProbePhases + i] += probe_acc()[i];
    }
  }
}
#else
__device__ __forceinline__ void probe_start() {}
__device__ __forceinline__ void probe_mark(int) {}
__device__ __forceinline__ void probe_sync(int) { __syncthreads(); }
__device__ __forceinline__ void probe_flush() {}
#endif

__host__ __device__ inline int round4(int x) { return (x + 3) & ~3; }
__host__ __device__ inline int round16(int x) { return (x + 15) & ~15; }

// The run-time shape of the body: its padding, its shared memory (in
// floats) and its panels and packed weights (in 16-byte words).  The
// wrapper's plan (ops/ppo_loss.py::wide_plan) computes the same numbers.
struct Shape {
  int D, A, H;
  int Hp, NB;   // units padded to 16, their n16 blocks
  int Dp, DB;   // obs rows padded to 16, their blocks
  int KS, KB;   // samples a packed k-block (16 bf16, 8 tf32), k-blocks a sub-block
  int SP;       // row stride of the [unit][sample] arrays: 4 mod 32 (bf16), 8 mod 32 (tf32)
  int act0, act1, x, inp, dout, red, b1, b2, wout, bo, ls, rec, ring, total;
  int p_h1, p_d2, p_d1, group;  // a sub-block's panels: x at 0, h1, dpre2, dpre1
  int w2f, w2b, packed;         // a tower's packed weights: W1 at 0, W2, W2^T
  int t1, t2;                   // bf16: W1 and W2 as rows of their units (the chain's)
  int planes;                   // of the packed weights: 1 (bf16), 2 (tf32 hi, lo)
};

__host__ __device__ inline Shape make_shape(int d, int a, int h, bool bf) {
  Shape s;
  s.D = d;
  s.A = a;
  s.H = h;
  s.Hp = round16(h);
  s.NB = s.Hp / 16;
  s.Dp = round16(d);
  s.DB = s.Dp / 16;
  s.KS = bf ? 16 : 8;
  s.KB = kS / s.KS;
  s.SP = kS + (bf ? 4 : 8);
  int off = 0;
  s.act0 = off;  // (unit, sample): h1, then dpre1
  off += s.Hp * s.SP;
  s.act1 = off;  // h2, then dpre2
  off += s.Hp * s.SP;
  s.x = off;  // (obs row, sample), rows D..Dp zero
  off += s.Dp * s.SP;
  s.inp = off;  // action (A), old logp, old value, raw advantage, return
  off += (a + 4) * s.SP;
  s.dout = off;  // the head's outputs, then their cotangents (tower 0: A rows, tower 1: 1)
  off += (a + 1) * s.SP;
  s.red = off;  // per-sample terms: tower 0 dls (A), pg, kl, clip; tower 1 v
  off += (a + 4) * s.SP;
  s.b1 = off;
  off += s.Hp;
  s.b2 = off;
  off += s.Hp;
  s.wout = off;  // the head's weights (unit, action), or (unit) for the value
  off += s.Hp * a;
  s.bo = off;  // pi_out.b (A), vf_out.b
  off += round4(a + 1);
  s.ls = off;
  off += round4(a);
  s.rec = off;  // bf16: 2 queue counts, then kRecCap queued (unit, sample)
  off += round4(2 + kRecCap);
  s.ring = off;  // the warps' phase A rings of packed weights
  off += kWarps * kRingA * 4;
  // Phase B's stages of panel words take the whole area from 0.
  s.total = off > kStages * kStageWords * 4 ? off : kStages * kStageWords * 4;
  s.p_h1 = s.DB * s.KB * 32;
  s.p_d2 = s.p_h1 + s.NB * s.KB * 32;
  s.p_d1 = s.p_d2 + s.NB * s.KB * 32;
  s.group = s.p_d1 + s.NB * s.KB * 32;
  s.w2f = s.NB * (s.Dp / s.KS) * 32;
  s.w2b = s.w2f + s.NB * (s.Hp / s.KS) * 32;
  s.t1 = s.w2b + s.NB * (s.Hp / s.KS) * 32;
  s.t2 = s.t1 + (bf ? s.Hp * s.Dp / 8 : 0);
  s.packed = s.t2 + (bf ? s.Hp * s.Hp / 8 : 0);
  s.planes = bf ? 1 : 2;
  return s;
}

__host__ __device__ inline int smem_bytes(const Shape& s) { return 4 * s.total; }

// Whether the wide body takes these widths (obs d, action a, hidden h).
__host__ __device__ inline bool takes(int d, int a, int h) {
  return d >= 1 && d <= kMaxObs && a >= 1 && a <= kMaxAction && h >= 1 && h <= kMaxHidden &&
         smem_bytes(make_shape(d, a, h, false)) <= kSmemLimit &&
         smem_bytes(make_shape(d, a, h, true)) <= kSmemLimit;
}

// The sub-blocks of a minibatch of mb samples.
__host__ __device__ inline long long sub_blocks(long long mb) { return (mb + kS - 1) / kS; }

// The CTAs of a launch over mb samples on `sms` SMs: two a sub-block (one
// a tower), at most one an SM, an even number.
__host__ __device__ inline int grid_blocks(long long mb, int sms) {
  const long long sub = sub_blocks(mb), half = sms / 2;
  return static_cast<int>(2 * (sub < half ? sub : half));
}

// The sub-blocks that one CTA takes at most: its panels' groups.
__host__ __device__ inline int groups_per_cta(long long mb, int blocks) {
  const long long per = blocks / 2;
  return static_cast<int>((sub_blocks(mb) + per - 1) / per);
}

// Whether plan[0..4) (samples a sub-block, shared memory bytes, groups a
// CTA, 16-byte words a group) and plan[4] (16-byte words of the packed
// weights, both towers) are the body's for these widths, dtype, minibatch
// and grid (an even number of CTAs from 2 to 2 x the sub-blocks); both
// wide launches refuse a plan that is not (ops/ppo_loss.py::wide_plan).
inline bool plan_ok(int d, int adim, int h, bool bf, long long mb, int blocks,
                    const long long* plan) {
  if (!takes(d, adim, h) || blocks < 2 || blocks % 2 || mb < 1 ||
      blocks > 2 * sub_blocks(mb)) {
    return false;
  }
  const Shape sh = make_shape(d, adim, h, bf);
  return plan[0] == kS && plan[1] == smem_bytes(sh) && plan[2] == groups_per_cta(mb, blocks) &&
         plan[3] == sh.group && plan[4] == 2LL * sh.planes * sh.packed;
}

// The tower whose CTAs hold entry e of the flat gradient then the 4 metrics
// [pg, v, kl, clip] in their partial rows.
__host__ __device__ inline int owner_tower(const ac::RtLayout& L, int e) {
  if (e < L.vf) return 0;  // log_std, the pi tower, pi_out
  if (e < L.net_size) return 1;
  return e - L.net_size == 1 ? 1 : 0;
}

struct LossCfg {
  float clip_eps, value_clip_eps, value_coef;
  float log_norm;  // 0.5 A log(2 pi), rounded to float from double as the twin's scalar
};

// 0.5 A log(2 pi) as the twin's Python scalar (ops/ppo_loss.py::logp_ratio):
// computed in double, rounded to float once.
inline float log_norm(int adim) { return static_cast<float>(0.5 * adim * 1.8378770664093453); }

// ---- tensor-core fragments ---------------------------------------------------
//
// The packed layout of an operand of 16 rows (units) by KS columns (samples,
// or the reduction index of a weight) is 32 lanes x 4 words: lane 4 g + q
// holds, for the bf16 layout (KS = 16, two bf16 a word, the lower column in
// the low half), rows g, g + 8 at columns 2q, 2q + 1 (words 0, 1) and at
// 2q + 8, 2q + 9 (words 2, 3); for the tf32 layout (KS = 8, a float32 a
// word), rows g, g + 8 at column q (words 0, 1) and q + 4 (words 2, 3).
// That is an m16k A fragment as it stands, and with words (0, 2) and
// (1, 3) the kn8 B fragments of rows 0-7 and 8-15.

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x (float32 bits, finite) as hi + lo, both tf32: hi = cvt.rna.tf32(x), lo
// = cvt.rna.tf32(x - hi), each as round half away from zero at the 13th
// bit from the bottom of the magnitude and the bits below cleared.
__device__ __forceinline__ void split_tf32(uint32_t x, uint32_t& hi, uint32_t& lo) {
  hi = (x + 0x1000u) & 0xffffe000u;
  const float r = __uint_as_float(x) - __uint_as_float(hi);
  lo = (__float_as_uint(r) + 0x1000u) & 0xffffe000u;
}

// Two floats rounded to bf16 (round to nearest even), lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// 16 bytes from global memory (through L2 only: in K4 other CTAs rewrite
// the packed weights between passes) into shared memory, asynchronously.
__device__ __forceinline__ void cp_async16(uint4* smem, const uint4* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :
               : "r"(static_cast<uint32_t>(__cvta_generic_to_shared(smem))), "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Until at most n - 1 of this thread's groups are in flight.
template <int n>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n - 1) : "memory");
}

// acc[i][n] += A_i B_n for the m16 tiles i < mi (A fragments a[i]) and the
// n8 tiles n < 2 nb (B fragments from b[n / 2], words (0, 2) or (1, 3)): bf16
// products, or 3xTF32 of float32 words, B split here or, with kBlo, given
// split (b the hi words, bl[kN2] the lo words).  mi and nb are
// warp-uniform.
template <bool kBf, int kM, int kN2, bool kBlo = false>
__device__ __forceinline__ void mma_block(float (&acc)[kM][2 * kN2][4], const uint4 (&a)[kM],
                                          const uint4 (&b)[kN2], int mi, int nb,
                                          const uint4* bl = nullptr) {
  if constexpr (kBf) {
#pragma unroll
    for (int i = 0; i < kM; ++i) {
      if (i < mi) {
        const uint32_t af[4] = {a[i].x, a[i].y, a[i].z, a[i].w};
#pragma unroll
        for (int j = 0; j < kN2; ++j) {
          if (j < nb) {
            mma_bf16(acc[i][2 * j], af, b[j].x, b[j].z);
            mma_bf16(acc[i][2 * j + 1], af, b[j].y, b[j].w);
          }
        }
      }
    }
  } else {
    uint32_t bh[kN2][4], blo[kN2][4];
#pragma unroll
    for (int j = 0; j < kN2; ++j) {
      if constexpr (kBlo) {
        bh[j][0] = b[j].x, bh[j][1] = b[j].y, bh[j][2] = b[j].z, bh[j][3] = b[j].w;
        blo[j][0] = bl[j].x, blo[j][1] = bl[j].y, blo[j][2] = bl[j].z, blo[j][3] = bl[j].w;
      } else {
        split_tf32(b[j].x, bh[j][0], blo[j][0]);
        split_tf32(b[j].y, bh[j][1], blo[j][1]);
        split_tf32(b[j].z, bh[j][2], blo[j][2]);
        split_tf32(b[j].w, bh[j][3], blo[j][3]);
      }
    }
#pragma unroll
    for (int i = 0; i < kM; ++i) {
      if (i < mi) {
        uint32_t ah[4], al[4];
        split_tf32(a[i].x, ah[0], al[0]);
        split_tf32(a[i].y, ah[1], al[1]);
        split_tf32(a[i].z, ah[2], al[2]);
        split_tf32(a[i].w, ah[3], al[3]);
#pragma unroll
        for (int j = 0; j < kN2; ++j) {
          if (j < nb) {
#pragma unroll
            for (int hf = 0; hf < 2; ++hf) {
              float(&c)[4] = acc[i][2 * j + hf];
#if !REINMAV_WIDE_ONE_TF32
              mma_tf32(c, al, bh[j][hf], bh[j][hf + 2]);
              mma_tf32(c, ah, blo[j][hf], blo[j][hf + 2]);
#endif
              mma_tf32(c, ah, bh[j][hf], bh[j][hf + 2]);
            }
          }
        }
      }
    }
  }
}

// ---- packed weights ------------------------------------------------------------

// The 32-bit word (and, in bf16, the half of it) of element (row n, column
// k) of a packed operand whose row blocks are kb k-blocks long.
__host__ __device__ inline int packed_word(int n, int k, int kb, bool bf, int* half) {
  const int blk = (n >> 4) * kb + (bf ? (k >> 4) : (k >> 3));
  const int r = n & 15, g = r & 7, rh = r >> 3;
  int q, kh;
  if (bf) {
    const int c = k & 15;
    q = (c & 7) >> 1;
    kh = c >> 3;
    *half = c & 1;
  } else {
    const int c = k & 7;
    q = c & 3;
    kh = c >> 2;
    *half = 0;
  }
  return blk * 128 + (4 * g + q) * 4 + rh + 2 * kh;
}

// Entry e of the flat parameters, of value w, into the packed weights (both
// towers, `packed` 32-bit words, zero where no entry lands): W1 of tower t
// as the forward's B operand (rows u, columns i), W2 as the forward's (rows
// u, columns j) and as dpre1's (rows j, columns u); any other entry is not
// packed.  bf16: w rounded to bf16; float32: its tf32 split, hi in the
// first plane (2 towers x Shape::packed 16-byte words), lo in the second.
template <bool kBf>
__device__ __forceinline__ void pack_entry(const Shape& sh, const ac::RtLayout& L,
                                           uint32_t* __restrict__ packed, int e, float w) {
  const int t = e >= L.vf ? 1 : 0;
  const int local = e - L.tower_base(t);
  if (local < L.w1 || local >= L.tower_hidden || (local >= L.b2 && local < L.w2)) return;
  uint32_t* tw = packed + t * sh.packed * 4;
  int half, word[2], halves[2], n_words;
  const int dkb = sh.Dp / sh.KS, hkb = sh.Hp / sh.KS;
  if (local < L.b2) {  // W1 (i, u)
    const int idx = local - L.w1, i = idx / sh.H, u = idx % sh.H;
    word[0] = packed_word(u, i, dkb, kBf, &half);
    halves[0] = half;
    n_words = 1;
  } else {  // W2 (j, u)
    const int idx = local - L.w2, j = idx / sh.H, u = idx % sh.H;
    word[0] = sh.w2f * 4 + packed_word(u, j, hkb, kBf, &half);
    halves[0] = half;
    word[1] = sh.w2b * 4 + packed_word(j, u, hkb, kBf, &half);
    halves[1] = half;
    n_words = 2;
  }
  if constexpr (kBf) {
    // The chain's rows: W1 (i, u) at unit u's row of Dp, W2 (j, u) at its
    // row of Hp.
    __nv_bfloat16* rows = reinterpret_cast<__nv_bfloat16*>(tw);
    if (local < L.b2) {
      const int idx = local - L.w1;
      rows[sh.t1 * 8 + (idx % sh.H) * sh.Dp + idx / sh.H] = __float2bfloat16_rn(w);
    } else {
      const int idx = local - L.w2;
      rows[sh.t2 * 8 + (idx % sh.H) * sh.Hp + idx / sh.H] = __float2bfloat16_rn(w);
    }
  }
  for (int k = 0; k < n_words; ++k) {
    if constexpr (kBf) {
      reinterpret_cast<__nv_bfloat16*>(tw)[2 * word[k] + halves[k]] = __float2bfloat16_rn(w);
    } else {
      uint32_t hi, lo;
      split_tf32(__float_as_uint(w), hi, lo);
      tw[word[k]] = hi;
      tw[2 * sh.packed * 4 + word[k]] = lo;
    }
  }
}

// ---- phase A -----------------------------------------------------------------

// The tower's biases, its head's weights (rounded to bf16 in kBf), pi_out.b
// and vf_out.b, and the log-std of `net` into shared memory, the padded
// units zero.  Through L2 (__ldcg): in K4 other CTAs rewrite `net` between
// passes.  The caller synchronises the block before they are read.
template <bool kBf>
__device__ __forceinline__ void load_small(float* sm, const Shape& sh, const ac::RtLayout& L,
                                           const float* net, int tower) {
  const int tid = threadIdx.x;
  const int base = L.tower_base(tower);
  for (int u = tid; u < sh.Hp; u += kThreads) {
    const bool real = u < sh.H;
    sm[sh.b1 + u] = real ? __ldcg(net + base + u) : 0.0f;
    sm[sh.b2 + u] = real ? __ldcg(net + base + L.b2 + u) : 0.0f;
  }
  if (tower == 0) {
    for (int idx = tid; idx < sh.Hp * sh.A; idx += kThreads) {
      sm[sh.wout + idx] = idx < sh.H * sh.A ? bf16r<kBf>(__ldcg(net + L.pi_out_w + idx)) : 0.0f;
    }
  } else {
    for (int j = tid; j < sh.Hp; j += kThreads) {
      sm[sh.wout + j] = j < sh.H ? bf16r<kBf>(__ldcg(net + L.vf_out_w + j)) : 0.0f;
    }
  }
  if (tid < sh.A) {
    sm[sh.bo + tid] = __ldcg(net + L.pi_out_b + tid);
    sm[sh.ls + tid] = __ldcg(net + tid);  // log_std at 0
  }
  if (tid == sh.A) sm[sh.bo + sh.A] = __ldcg(net + L.vf_out_b);
}

// A warp's product over the sub-block: acc[i][n] = sum over k < K of
// in[k][16 i + row] W[k][col] for its n16 block `warp` (n8 tiles 0-1;
// none when warp >= NB), `in` the [k][sample] rows of shared memory (K a
// multiple of 16), W the packed operand of K / KS k-blocks a row block (in
// float32 its hi plane; the lo plane 2 x Shape::packed words on).  Each
// lane copies its own B words a k-step ahead into the warp's ring
// (cp.async) and reads back only its own, so the warp needs no barrier.
// Returns whether the warp has a block.
template <bool kBf>
__device__ __forceinline__ bool warp_product(const float* __restrict__ in, const Shape& sh, int K,
                                             const uint4* __restrict__ W, uint4* ring, int warp,
                                             int lane, float (&acc)[kMT][2][4]) {
#pragma unroll
  for (int i = 0; i < kMT; ++i) {
#pragma unroll
    for (int n = 0; n < 2; ++n) {
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][n][r] = 0.0f;
    }
  }
  if (warp >= sh.NB) return false;
  const int g = lane >> 2, q = lane & 3, SP = sh.SP;
  const int kbs = K / sh.KS;
  const int lo_plane = 2 * sh.packed;
  const uint4* w0 = W + warp * kbs * 32 + lane;
  uint4* const mine = ring + lane;
  auto issue = [&](int kb) {
    uint4* slot = mine + (kb % kDepthA) * 64;
    cp_async16(slot, w0 + kb * 32);
    if constexpr (!kBf) cp_async16(slot + 32, w0 + lo_plane + kb * 32);
  };
#pragma unroll
  for (int p = 0; p < kDepthA - 1; ++p) {
    if (p < kbs) issue(p);
    cp_async_commit();
  }
  for (int kb = 0; kb < kbs; ++kb) {
    if (kb + kDepthA - 1 < kbs) issue(kb + kDepthA - 1);
    cp_async_commit();
    cp_async_wait<kDepthA>();
    const uint4* slot = mine + (kb % kDepthA) * 64;
    const uint4 b[1] = {slot[0]};
    uint4 a[kMT];
#pragma unroll
    for (int i = 0; i < kMT; ++i) {
      if constexpr (kBf) {
        const float* r = in + (kb * 16 + 2 * q) * SP + 16 * i + g;
        a[i] = make_uint4(pack_bf16(r[0], r[SP]), pack_bf16(r[8], r[SP + 8]),
                          pack_bf16(r[8 * SP], r[9 * SP]), pack_bf16(r[8 * SP + 8], r[9 * SP + 8]));
      } else {
        const float* r = in + (kb * 8 + q) * SP + 16 * i + g;
        a[i] = make_uint4(__float_as_uint(r[0]), __float_as_uint(r[8]),
                          __float_as_uint(r[4 * SP]), __float_as_uint(r[4 * SP + 8]));
      }
    }
    if constexpr (kBf) {
      mma_block<kBf, kMT, 1>(acc, a, b, kMT, 1);
    } else {
      const uint4 bl[1] = {slot[32]};
      mma_block<kBf, kMT, 1, true>(acc, a, b, kMT, 1, bl);
    }
  }
  return true;
}

// The unit (the column of the product) and the sample (its row) of
// accumulator slot r of m16 tile i and n8 tile n of a warp's product.
__device__ __forceinline__ int slot_unit(int warp, int lane, int n, int r) {
  return warp * 16 + 8 * n + 2 * (lane & 3) + (r & 1);
}
__device__ __forceinline__ int slot_sample(int lane, int i, int r) {
  return 16 * i + (lane >> 2) + 8 * (r >> 1);
}

// Whether h lies within tie(h) of the midpoint between its two bf16
// neighbours, where another order of summation can round it the other way.
__device__ __forceinline__ bool near_midpoint(float h) {
  const float mid = __uint_as_float((__float_as_uint(h) & 0xffff0000u) | 0x8000u);
  return fabsf(h - mid) <= kTieAbs + kTieRel * fabsf(h);
}

// The twin's order for unit u of sample s of a layer (bf16): an FMA chain
// from 0 over the k < K inputs in[k][s] (rounded to bf16) times W[k][u]
// (`rows` the layer's weights as bf16 rows of their units, `stride` bf16
// apart, read 64 at a time, 16 bytes a load), the bias added last, then
// tanhf.  Not inlined: it is called from the rare paths of forward_store's
// unrolled epilogue.
static __device__ __noinline__ float chain_h(const float* in, const Shape& sh, int K,
                                             const __nv_bfloat16* __restrict__ rows, int stride,
                                             float bias, int u, int s) {
  const uint4* row = reinterpret_cast<const uint4*>(rows + u * stride);
  float acc = 0.0f;
  for (int k0 = 0; k0 < K; k0 += 64) {
    uint4 w[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      w[c] = k0 + 8 * c < K ? __ldcg(row + k0 / 8 + c) : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const uint32_t ws[4] = {w[c].x, w[c].y, w[c].z, w[c].w};
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int k = k0 + 8 * c + e;
        const float wk = __uint_as_float(e & 1 ? ws[e >> 1] & 0xffff0000u : ws[e >> 1] << 16);
        if (k < K) acc = fmaf(bf16r<true>(in[k * sh.SP + s]), wk, acc);
      }
    }
  }
  return tanhf(acc + bias);
}

// A forward layer's outputs: out[u][s] = tanhf(acc + b[u]) for the warp's
// slots; in bf16, the h's of real units and of the sub-block's `valid`
// samples (those beyond it are the minibatch's padding, their cotangents
// 0) near a bf16 midpoint are queued (one atomic a warp; recomputed in the
// twin's order by flush_recompute), or recomputed here when the queue is
// full.  `count` the layer's queue count, `in`, K, W and stride the
// layer's inputs and weights for the twin's chain.
template <bool kBf>
__device__ __forceinline__ void forward_store(const float (&acc)[kMT][2][4], bool has,
                                              const float* b, float* out, const Shape& sh,
                                              int warp, int lane, int* count, int* queue,
                                              const float* in, int K, const __nv_bfloat16* W,
                                              int stride, int valid, int layer) {
  if (!has) return;
  uint32_t near = 0;  // the lane's slots (i, n, r) at bit (i 2 + n) 4 + r
#pragma unroll
  for (int i = 0; i < kMT; ++i) {
#pragma unroll
    for (int n = 0; n < 2; ++n) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int u = slot_unit(warp, lane, n, r), s = slot_sample(lane, i, r);
        const float h = tanhf(acc[i][n][r] + b[u]);
        if constexpr (kBf) {
          near |= static_cast<uint32_t>(u < sh.H && s < valid && near_midpoint(h))
                  << ((i * 2 + n) * 4 + r);
        }
        out[u * sh.SP + s] = h;
      }
    }
  }
  if constexpr (kBf) {
    const int mine = __popc(near);
    int upto = mine;  // inclusive prefix over the lanes
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, upto, off);
      if (lane >= off) upto += v;
    }
    const int total = __shfl_sync(0xffffffffu, upto, 31);
    int base = 0;
    if (lane == 31 && total > 0) base = atomicAdd(count, total);
    base = __shfl_sync(0xffffffffu, base, 31) + upto - mine;
    for (uint32_t m = near; m != 0; m &= m - 1, ++base) {
      const int slot = __ffs(m) - 1, i = slot >> 3, n = (slot >> 2) & 1, r = slot & 3;
      const int u = slot_unit(warp, lane, n, r), s = slot_sample(lane, i, r);
      if (base < kRecCap) {
        queue[base] = u * kS + s;
      } else {
        out[u * sh.SP + s] = chain_h(in, sh, K, W, stride, b[u], u, s);
      }
    }
  }
#if REINMAV_WIDE_PROBE
  if (kBf && g_wide_miss != nullptr) {
    // Every h of a real unit against the twin's chain, from the tensor
    // cores' sums: those in the window (recomputed) and those outside it
    // whose bf16 rounding the chain's differs from (missed).
    for (int slot = 0; slot < kMT * 8; ++slot) {
      const int i = slot >> 3, n = (slot >> 2) & 1, r = slot & 3;
      const int u = slot_unit(warp, lane, n, r), s = slot_sample(lane, i, r);
      if (u >= sh.H || s >= valid) continue;
      float a = 0.0f;
#pragma unroll
      for (int ii = 0; ii < kMT; ++ii) {
#pragma unroll
        for (int nn = 0; nn < 2; ++nn) {
#pragma unroll
          for (int rr = 0; rr < 4; ++rr) {
            if (ii == i && nn == n && rr == r) a = acc[ii][nn][rr];
          }
        }
      }
      const float h = tanhf(a + b[u]);
      const float c = chain_h(in, sh, K, W, stride, b[u], u, s);
      const bool near = near_midpoint(h);
      atomicAdd(g_wide_miss + 3 * layer, 1ull);
      if (near) atomicAdd(g_wide_miss + 3 * layer + 1, 1ull);
      if (!near && bf16r<true>(c) != bf16r<true>(h)) atomicAdd(g_wide_miss + 3 * layer + 2, 1ull);
      // How far the tensor cores' h lies from the chain's, against the
      // window: beyond a quarter of it, beyond half of it.
      const float d = fabsf(h - c), tie = kTieAbs + kTieRel * fabsf(h);
      if (d > 0.25f * tie) atomicAdd(g_wide_miss + 6 + 2 * layer, 1ull);
      if (d > 0.5f * tie) atomicAdd(g_wide_miss + 7 + 2 * layer, 1ull);
    }
  }
#endif
  (void)count;
  (void)queue;
  (void)in;
  (void)K;
  (void)W;
  (void)stride;
  (void)valid;
  (void)layer;
}

// The queued h's of a layer, recomputed in the twin's order by the CTA's
// threads (the queue's first kRecCap; the rest were recomputed as they were
// queued).  Between two barriers.
__device__ __forceinline__ void flush_recompute(const int* count, const int* queue, float* out,
                                                const float* b, const Shape& sh, const float* in,
                                                int K, const __nv_bfloat16* W, int stride) {
  const int n = min(*count, kRecCap);
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int us = queue[i], u = us / kS, s = us % kS;
    out[u * sh.SP + s] = chain_h(in, sh, K, W, stride, b[u], u, s);
  }
}

// Row blocks [0, blocks) of a [unit][sample] array into a panel of the
// packed layout: block (row block, k-block) at ((row block) KB + k-block) 32
// + lane; bf16 rounded to bf16, float32 as it is.
template <bool kBf>
__device__ __forceinline__ void write_panel(const float* __restrict__ arr, int blocks,
                                            const Shape& sh, uint4* __restrict__ dst) {
  const int n = blocks * sh.KB * 32;
  const int kb_shift = sh.KB == 8 ? 3 : 2;
  for (int idx = threadIdx.x; idx < n; idx += kThreads) {
    const int lane = idx & 31, blk = idx >> 5;
    const int rb = blk >> kb_shift, kb = blk & (sh.KB - 1);
    const int g = lane >> 2, q = lane & 3;
    const float* r0 = arr + (rb * 16 + g) * sh.SP;
    const float* r1 = r0 + 8 * sh.SP;
    uint4 v;
    if constexpr (kBf) {
      const int s = kb * 16 + 2 * q;
      v = make_uint4(pack_bf16(r0[s], r0[s + 1]), pack_bf16(r1[s], r1[s + 1]),
                     pack_bf16(r0[s + 8], r0[s + 9]), pack_bf16(r1[s + 8], r1[s + 9]));
    } else {
      const int s = kb * 8 + q;
      v = make_uint4(__float_as_uint(r0[s]), __float_as_uint(r1[s]), __float_as_uint(r0[s + 4]),
                     __float_as_uint(r1[s + 4]));
    }
    dst[idx] = v;
  }
}

// The entries a tower's threads sum per sample in registers, entry e held
// by thread e % 256 in its slot e / 256: tower 0 dwpi (H A, e = j A + a),
// dbo (A), dls (A), pg, kl, clip, then db2 (H), db1 (H); tower 1 dwvf (H),
// dbo, v, then db2, db1.
struct Small {
  int heads;  // the entries before db2
  int total;
};

__device__ __forceinline__ Small small_entries(const Shape& sh, int tower) {
  Small m;
  m.heads = tower == 0 ? sh.H * sh.A + 2 * sh.A + 3 : sh.H + 2;
  m.total = m.heads + 2 * sh.H;
  return m;
}

// The flat index (then the 4 metrics) of small entry e of the tower.
__device__ __forceinline__ int small_flat(const Shape& sh, const ac::RtLayout& L, int tower,
                                          const Small& m, int e) {
  if (e >= m.heads) {
    const int u = e - m.heads;
    return u < sh.H ? L.tower_base(tower) + L.b2 + u : L.tower_base(tower) + (u - sh.H);
  }
  if (tower == 0) {
    const int ha = sh.H * sh.A;
    if (e < ha) return L.pi_out_w + e;
    if (e < ha + sh.A) return L.pi_out_b + (e - ha);
    if (e < ha + 2 * sh.A) return e - ha - sh.A;  // log_std
    const int k = e - ha - 2 * sh.A;              // pg, kl, clip
    return L.net_size + (k == 0 ? 0 : k + 1);
  }
  if (e < sh.H) return L.vf_out_w + e;
  return e == sh.H ? L.vf_out_b : L.net_size + 1;
}

// The loss gradient over the sub-blocks of kS samples of the minibatch of
// `mb` samples defined by `perm` that CTA blockIdx.x takes (tower
// blockIdx.x % 2, every (gridDim.x / 2)-th sub-block from blockIdx.x / 2),
// with load_small's values already in `sm` (the caller synchronised after
// it) and the weights packed in `packed` (pack_entry).  Writes the CTA's
// raw sums of its tower's entries (owner_tower) into `out`, using `panels`
// (groups_per_cta groups of sh.group words) as the CTA's scratch.
// rec_counts, when not null, gets the h1's and h2's recomputed (added).
// Ends with a block synchronisation.
template <bool kKl, bool kBf>
__device__ __forceinline__ void loss_body(float* sm, const Shape& sh, const ac::RtLayout& L,
                                          const uint4* __restrict__ packed,
                                          const float* __restrict__ data, int64_t n,
                                          const int* __restrict__ perm, int64_t mb, int tile,
                                          float adv_shift, float adv_inv, float kl_beta,
                                          const LossCfg& cfg, uint4* __restrict__ panels,
                                          float* __restrict__ out,
                                          unsigned long long* __restrict__ rec_counts) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int D = sh.D, A = sh.A, H = sh.H, SP = sh.SP;
  const int tower = blockIdx.x & 1;
  const int cta = blockIdx.x >> 1, ctas = gridDim.x >> 1;
  float* const act0 = sm + sh.act0;
  float* const act1 = sm + sh.act1;
  float* const x = sm + sh.x;
  float* const inp = sm + sh.inp;
  float* const dout = sm + sh.dout;
  float* const red = sm + sh.red;
  int* const counts = reinterpret_cast<int*>(sm + sh.rec);
  int* const queue = counts + 2;
  const uint4* const pk = packed + tower * sh.packed;
  const __nv_bfloat16* const rows1 = reinterpret_cast<const __nv_bfloat16*>(pk + sh.t1);
  const __nv_bfloat16* const rows2 = reinterpret_cast<const __nv_bfloat16*>(pk + sh.t2);
  uint4* const ring = reinterpret_cast<uint4*>(sm + sh.ring) + warp * kRingA;
  for (int e = tid; e < (sh.Dp - D) * SP; e += kThreads) x[D * SP + e] = 0.0f;
  const Small sm_e = small_entries(sh, tower);
  float small[kSmall];
#pragma unroll
  for (int k = 0; k < kSmall; ++k) small[k] = 0.0f;
  unsigned long long recomputed[2] = {0, 0};
  // The per-sample row phases (P0, P6): thread (rows r0, r0 + 4, ...,
  // sample s_own).
  const int s_own = tid % kS, r0 = tid / kS, rstep = kThreads / kS;
  float acc[kMT][2][4];
  __syncthreads();
  probe_start();

  const int64_t n_sub = (mb + kS - 1) / kS;
  int j = 0;  // the CTA's sub-blocks so far: its panels' group
  for (int64_t blk = cta; blk < n_sub; blk += ctas, ++j) {
    uint4* const grp = panels + static_cast<int64_t>(j) * sh.group;
    const int valid = static_cast<int>(mb - blk * kS < kS ? mb - blk * kS : kS);
    // ---- P0: the sub-block's inputs, gathered: sample q of the minibatch
    // is column perm[q / tile] * tile + q % tile of `data` ----------------
    {
      const int64_t q = blk * kS + s_own;
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
    if (tid < 2) counts[tid] = 0;
    probe_sync(kPhGather);

    // ---- P1: h1 = tanh(x W1 + b1) --------------------------------------
    {
      const bool has = warp_product<kBf>(x, sh, sh.Dp, pk, ring, warp, lane, acc);
      forward_store<kBf>(acc, has, sm + sh.b1, act0, sh, warp, lane, counts, queue, x, D, rows1,
                         sh.Dp, valid, 0);
    }
    probe_sync(kPhFwdProducts);
    if constexpr (kBf) {
      flush_recompute(counts, queue, act0, sm + sh.b1, sh, x, D, rows1, sh.Dp);
      if (tid == 0) recomputed[0] += counts[0];
      probe_sync(kPhRecompute);
    }

    // ---- P2: h2 = tanh(h1 W2 + b2); the x and h1 panels -------------------
    {
      const bool has = warp_product<kBf>(act0, sh, sh.Hp, pk + sh.w2f, ring, warp, lane, acc);
      forward_store<kBf>(acc, has, sm + sh.b2, act1, sh, warp, lane, counts + 1, queue, act0, H,
                         rows2, sh.Hp, valid, 1);
    }
    if constexpr (kBf) {
      // The h2 queue complete, then its recompute beside the x and h1
      // panels (which read x and h1 only).  The h1 queue is spent; h2's
      // reuses it, counted apart.
      probe_sync(kPhFwdProducts);
      flush_recompute(counts + 1, queue, act1, sm + sh.b2, sh, act0, H, rows2, sh.Hp);
      if (tid == 0) recomputed[1] += counts[1];
      probe_mark(kPhRecompute);
    } else {
      probe_mark(kPhFwdProducts);
    }
    write_panel<kBf>(x, sh.DB, sh, grp);
    write_panel<kBf>(act0, sh.NB, sh, grp + sh.p_h1);
    probe_sync(kPhPanels);

    // ---- P3: the head (tower 0 the mean: thread (action, sample); tower 1
    // the value: thread a sample) --------------------------------------------
    if (tower == 0) {
      for (int c = tid; c < kS * A; c += kThreads) {
        const int s = c % kS, a = c / kS;
        float mean = 0.0f;
        for (int jj = 0; jj < H; ++jj) {
          mean = fmaf(bf16r<kBf>(act1[jj * SP + s]), sm[sh.wout + jj * A + a], mean);
        }
        dout[a * SP + s] = mean + sm[sh.bo + a];
      }
    } else if (tid < kS) {
      // The value head rounds each product and sum apart, in j order, as
      // its twin does (ops/ppo_loss.py::value_head).
      const int s = tid;
      float value = 0.0f;
      for (int jj = 0; jj < H; ++jj) {
        value = __fadd_rn(value, __fmul_rn(bf16r<kBf>(act1[jj * SP + s]), sm[sh.wout + jj]));
      }
      dout[s] = value + sm[sh.bo + A];
    }
    probe_sync(kPhHeadsLoss);

    // ---- P4: per-sample loss and its cotangent (threads 0..kS-1) ---------
    if (tid < kS) {
      const int s = tid;
      const bool ok = blk * kS + s < mb;
      if (tower == 0) {
        if (ok) {
          const float* ls = sm + sh.ls;
          // logp and the ratio rounded one operation at a time, in the
          // twin's order (ops/ppo_loss.py::logp_ratio).
          float qsum = 0.0f, ls_sum = 0.0f;
          for (int a = 0; a < A; ++a) {
            const float var = expf(2.0f * ls[a]);
            const float diff = __fsub_rn(inp[a * SP + s], dout[a * SP + s]);
            qsum = __fadd_rn(qsum, __fdiv_rn(__fmul_rn(diff, diff), var));
            ls_sum = __fadd_rn(ls_sum, ls[a]);
          }
          const float old_logp = inp[A * SP + s];
          const float adv = (inp[(A + 2) * SP + s] - adv_shift) * adv_inv;
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
          for (int a = 0; a < A; ++a) {
            const float var = expf(2.0f * ls[a]);
            const float diff = __fsub_rn(inp[a * SP + s], dout[a * SP + s]);
            const float quad = __fdiv_rn(__fmul_rn(diff, diff), var);
            dout[a * SP + s] = dlogp * (diff / var);
            red[a * SP + s] = dlogp * (quad - 1.0f);
          }
          red[A * SP + s] = pg;
          red[(A + 1) * SP + s] = kl;
          red[(A + 2) * SP + s] = fabsf(ratio - 1.0f) > cfg.clip_eps ? 1.0f : 0.0f;
        } else {
          for (int a = 0; a < A; ++a) dout[a * SP + s] = 0.0f;
          for (int r = 0; r < A + 3; ++r) red[r * SP + s] = 0.0f;
        }
      } else {
        if (ok) {
          const float value = dout[s];
          const float old_value = inp[(A + 1) * SP + s];
          const float ret = inp[(A + 3) * SP + s];
          const float vdiff = value - old_value;
          const float vcl =
              old_value + fminf(fmaxf(vdiff, -cfg.value_clip_eps), cfg.value_clip_eps);
          const float e1 = value - ret, e2 = vcl - ret;
          const float sq1 = e1 * e1, sq2 = e2 * e2;
          const float vin = fabsf(vdiff) < cfg.value_clip_eps ? 1.0f : 0.0f;
          const float vs1 = sq1 > sq2 ? 1.0f : 0.0f;
          const float vs2 = sq2 > sq1 ? 1.0f : 0.0f;
          const float vtie = 1.0f - vs1 - vs2;
          dout[s] = cfg.value_coef * (vs1 * e1 + vs2 * e2 * vin + 0.5f * vtie * (e1 + e2 * vin));
          red[s] = 0.5f * fmaxf(sq1, sq2);
        } else {
          dout[s] = 0.0f;
          red[s] = 0.0f;
        }
      }
    }
    probe_sync(kPhHeadsLoss);

    // ---- P5: the head's gradients, dbo, log-std and the metrics, summed
    // per sample in order into the owners' registers -------------------------
#pragma unroll
    for (int k = 0; k < kSmall; ++k) {
      const int e = tid + k * kThreads;
      if (e < sm_e.heads) {
        float g = small[k];
        const float* p;
        const float* w = nullptr;
        if (tower == 0) {
          const int ha = H * A;
          if (e < ha) {
            p = dout + (e % A) * SP;
            w = act1 + (e / A) * SP;
          } else if (e < ha + A) {
            p = dout + (e - ha) * SP;
          } else {
            p = red + (e - ha - A) * SP;  // dls (A), pg, kl, clip
          }
        } else if (e < H) {
          p = dout;
          w = act1 + e * SP;
        } else {
          p = e == H ? dout : red;
        }
        if (w != nullptr) {
          for (int s = 0; s < kS; ++s) g = fmaf(bf16r<kBf>(w[s]), bf16r<kBf>(p[s]), g);
        } else {
          for (int s = 0; s < kS; ++s) g += p[s];
        }
        small[k] = g;
      }
    }
    probe_sync(kPhHeadGrads);

    // ---- P6: dpre2 = (W_out dout) * (1 - h2^2), in place of h2 -----------
    for (int r = r0; r < H; r += rstep) {
      const int s = s_own;
      float dh;
      if (tower == 0) {
        dh = 0.0f;
        for (int a = 0; a < A; ++a) dh += sm[sh.wout + r * A + a] * bf16r<kBf>(dout[a * SP + s]);
      } else {
        dh = sm[sh.wout + r] * bf16r<kBf>(dout[s]);
      }
      float* p = act1 + r * SP + s;
      const float h = *p;
      *p = dh * (1.0f - h * h);
    }
    probe_sync(kPhDpre2);

    // ---- P7: dpre1 = (dpre2 W2^T) * (1 - h1^2), in place of h1; the dpre2
    // panel and db2 ---------------------------------------------------------
    if (warp_product<kBf>(act1, sh, sh.Hp, pk + sh.w2b, ring, warp, lane, acc)) {
#pragma unroll
      for (int i = 0; i < kMT; ++i) {
#pragma unroll
        for (int nn = 0; nn < 2; ++nn) {
          {
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              float* p = act0 + slot_unit(warp, lane, nn, r) * SP + slot_sample(lane, i, r);
              const float h = *p;
              *p = acc[i][nn][r] * (1.0f - h * h);
            }
          }
        }
      }
    }
    probe_mark(kPhDpreProducts);
    write_panel<kBf>(act1, sh.NB, sh, grp + sh.p_d2);
#pragma unroll
    for (int k = 0; k < kSmall; ++k) {
      const int e = tid + k * kThreads - sm_e.heads;
      if (e >= 0 && e < H) {
        float g = small[k];
        const float* p = act1 + e * SP;
        for (int s = 0; s < kS; ++s) g += p[s];
        small[k] = g;
      }
    }
    probe_sync(kPhPanels);

    // ---- P8: the dpre1 panel and db1 -------------------------------------
    write_panel<kBf>(act0, sh.NB, sh, grp + sh.p_d1);
#pragma unroll
    for (int k = 0; k < kSmall; ++k) {
      const int e = tid + k * kThreads - sm_e.heads - H;
      if (e >= 0 && e < H) {
        float g = small[k];
        const float* p = act0 + e * SP;
        for (int s = 0; s < kS; ++s) g += p[s];
        small[k] = g;
      }
    }
    probe_mark(kPhPanels);
    // The next sub-block's P0 writes x, inp and the counts only; its
    // barrier orders these reads of act0 and act1 before P1 writes them.
  }
  probe_sync(kPhPanels);  // the panels written, before phase B reads them

  // ---- phase B: dW2 = h1^T dpre2, dW1 = x^T dpre1 over the CTA's j
  // sub-blocks; a CTA tile of 8 x 8 blocks of 16 x 16, warp (wm, wn) its
  // m16 blocks 4 wm.. and n16 block wn.  The tile's A and B words go
  // through shared memory kStageK k-steps a stage, kStages - 1 stages
  // ahead, each copied once by the CTA's threads (cp.async) --------------
  {
    const int wm = warp >> 3, wn = warp & 7, g = lane >> 2, q = lane & 3;
    const int kb_shift = sh.KB == 8 ? 3 : 2;
    const int stages = j * sh.KB / kStageK;
    uint4* const stage = reinterpret_cast<uint4*>(sm);
    for (int mat = 0; mat < 2; ++mat) {
      const int mblocks = mat == 0 ? sh.NB : sh.DB;
      const int m_real = mat == 0 ? H : D;
      const int aoff = mat == 0 ? sh.p_h1 : 0, boff = mat == 0 ? sh.p_d2 : sh.p_d1;
      float* const dst = out + L.tower_base(tower) + (mat == 0 ? L.w2 : L.w1);
      for (int m0 = 0; m0 < mblocks; m0 += 8) {
        for (int n0 = 0; n0 < sh.NB; n0 += 8) {
          const int mb0 = m0 + 4 * wm, nb0 = n0 + wn;
          const int mi = max(0, min(4, mblocks - mb0)), ni = max(0, min(1, sh.NB - nb0));
          float c[4][2][4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
#pragma unroll
            for (int nn = 0; nn < 2; ++nn) {
#pragma unroll
              for (int r = 0; r < 4; ++r) c[i][nn][r] = 0.0f;
            }
          }
          // Stage st: k-steps kStageK st.. of the CTA tile, [k-step][A blocks
          // m0.., B blocks n0..][lane]; blocks beyond the matrix not copied
          // (their warps skip them).
          auto issue = [&](int st) {
            const int k0 = st * kStageK;
            const uint4* grp = panels + static_cast<int64_t>(k0 >> kb_shift) * sh.group;
            const int kb0 = k0 & (sh.KB - 1);
            uint4* const dst_stage = stage + (st % kStages) * kStageWords;
            for (int idx = tid; idx < kStageWords; idx += kThreads) {
              const int ln = idx & 31, kk = (idx >> 5) & (kStageK - 1);
              const int blk = (idx >> 7) & 7, side = idx >> 10;
              const int b = (side ? n0 : m0) + blk;
              if (b < (side ? sh.NB : mblocks)) {
                cp_async16(dst_stage + (kk * 16 + 8 * side + blk) * 32 + ln,
                           grp + (side ? boff : aoff) + (b * sh.KB + kb0 + kk) * 32 + ln);
              }
            }
          };
#pragma unroll
          for (int p = 0; p < kStages - 1; ++p) {
            if (p < stages) issue(p);
            cp_async_commit();
          }
          for (int st = 0; st < stages; ++st) {
            if (st + kStages - 1 < stages) issue(st + kStages - 1);
            cp_async_commit();
            cp_async_wait<kStages>();
            __syncthreads();  // every thread's copies of stage st
            if (mi > 0 && ni > 0) {
              const uint4* src = stage + (st % kStages) * kStageWords + lane;
#pragma unroll
              for (int kk = 0; kk < kStageK; ++kk) {
                const uint4* row = src + kk * 16 * 32;
                const uint4 a[4] = {row[(4 * wm) * 32], row[(4 * wm + 1) * 32],
                                    row[(4 * wm + 2) * 32], row[(4 * wm + 3) * 32]};
                const uint4 b[1] = {row[(8 + wn) * 32]};
                mma_block<kBf, 4, 1>(c, a, b, mi, ni);
              }
            }
            __syncthreads();  // stage st read, before its slot is copied into again
          }
#pragma unroll
          for (int i = 0; i < 4; ++i) {
#pragma unroll
            for (int nn = 0; nn < 2; ++nn) {
#pragma unroll
              for (int r = 0; r < 4; ++r) {
                const int m = (mb0 + i) * 16 + g + 8 * (r >> 1);
                const int col = nb0 * 16 + 8 * nn + 2 * q + (r & 1);
                if (i < mi && ni > 0 && m < m_real && col < H) {
                  dst[m * H + col] = c[i][nn][r];
                }
              }
            }
          }
        }
      }
    }
  }
  probe_mark(kPhWgrad);

  // ---- the small entries, each written once by its owner ----------------
#pragma unroll
  for (int k = 0; k < kSmall; ++k) {
    const int e = tid + k * kThreads;
    if (e < sm_e.total) out[small_flat(sh, L, tower, sm_e, e)] = small[k];
  }
  if (kBf && rec_counts != nullptr && tid == 0) {
    atomicAdd(rec_counts, recomputed[0]);
    atomicAdd(rec_counts + 1, recomputed[1]);
  }
  probe_flush();
  __syncthreads();
}

}  // namespace ppo_wide
}  // namespace reinmav
