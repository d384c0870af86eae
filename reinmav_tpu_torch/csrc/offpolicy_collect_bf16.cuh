// K7's bf16 instance (compute_dtype "bfloat16"): the fused off-policy
// collection step of offpolicy_collect.cu with the actor's two hidden
// layers on the tensor cores (mma.sync.aligned.m16n8k16.row.col.f32.bf16.
// bf16.f32, mma_bf16.cuh).  The same function as the float32 kernel in the
// TPU kernel's bf16 mode (reinmav_tpu/ops/pallas_offpolicy.py::
// collect_step_pallas :155, its products :97-101 with cd bf16 :186): every
// operand of a product rounded to bf16, the exact products summed in
// float32.  Its plain twin is ops/offpolicy.py::collect_step_reference
// with compute_dtype "bfloat16" (_actor_bf16).
//
// What bounds it: at D = 13, H1 = H2 = 256 and OUT = 8 the products are
// 2 (13 256 + 256 256 + 256 8) = 142k operations an env, 0.009 ms for
// 65,536 envs at 989 TFLOP/s; about 232 B an env of states and block.
// The float32 kernel ran them as FP32 FMAs (67 TFLOP/s at best) and
// streamed W2 through a ring, because 256 x 256 float32 (256 KB) do not
// fit a CTA's 227 KB.
//
// Design.  A persistent CTA of 320 threads, one an SM, walks tiles of 64
// envs (blockIdx.x, + gridDim.x, ...): its 8 MLP warps run the actor of
// tile n while its 2 env warps run the action, env step, block and reset
// of tile n - 1, the head outputs double-buffered between them (named
// barriers READY and FREE, as the float32 kernel).  W2 in bf16, 256 x 264
// (128 KB with its padding), sits whole in shared memory, staged once a
// CTA with W1, the head's W3 and the biases; what is left holds a tile of
// 64 envs: their bf16 states, h1 and h2 rows (229,664 B in all at H1 = H2
// = 256, OUT = 8, of 232,448).  MLP warp w takes rows 16 (w % 4) .. + 15
// of the tile and half of the layer's columns (w / 4), as m16n8k16 tiles:
//   L1  h1 = relu(x W1 + b1)   16 x H1/2 x 16 (D padded to 16 with zeros)
//   L2  h2 = relu(h1 W2 + b2)  16 x H2/2 x H1, h1's A fragments from the
//       tile's rows (ldmatrix), W2's B fragments with ldmatrix.trans
// each layer's outputs rounded to bf16 once, when stored to the tile's
// rows.  The widths are zero-padded: H1 to 16, H2 to 32 (the head's
// chunks), the padded weights and biases zero, so a padded unit is +0.
// The head (OUT = 2A or A <= 8 columns) is FP32 FMAs on the bf16 h2 rows
// in the twin's chunk fold (_actor_bf16): MLP thread t takes env t % 64
// and columns t / 64 and t / 64 + 4; each chunk of 32 units as 8 runs of
// 4 units, each run from 0, run g and run g + 4 added, then (0 + 2) + (1 +
// 3); the chunks added in order from 0, then the bias.  Given the twin's
// bf16 h2 the head is the twin's bit for bit.
//
// Numerics.  The tensor cores sum in their own order, so a layer's
// pre-activation may differ from the twin's FMA chain in its last bits,
// and an h near the midpoint between its two bf16 neighbours, or near 0
// where the ReLU decides, could round the other way: a whole bf16 step
// (2^-8 relative) on one unit.  So every pre-activation within tie(v) =
// kTieAbs + |v| kTieRel of a bf16 midpoint, or of 0, is recomputed in the
// twin's order, from 0 over the layer's inputs in order, then the bias:
// the warp's flagged units handed out one a lane (tc::for_each_flagged),
// so that the warp takes one pass of a 256-long FMA chain for up to 32 of
// them, not one for each unit its busiest lane holds.  Then the bf16 h1 and h2, and
// the head, are the twin's, as long as the tensor cores' sum lies within
// tie(v) of the twin's.  The probe instance (kProbe, launched by
// offpolicy_collect_bf16_probe_launch, never by a training path)
// recomputes every pre-activation in the twin's order and counts the
// units recomputed, the misses (a bf16 h that differs from the twin's
// without being recomputed: 0 when tie(v) holds) and the largest |sum -
// twin's| / tie(twin's) of each layer.  No atomics on the main path: a
// rerun is bitwise equal.  Widths: H1 and H2 each from 1 to 256, as the
// float32 kernel (past 256: offpolicy_collect_wide_bf16.cu).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "env_kinds.cuh"
#include "mma_bf16.cuh"

namespace reinmav {
namespace offpolicy_bf16 {

using tc::bf16;

constexpr int kMlp = 256;         // threads of the MLP warps (8)
constexpr int kEnvThreads = 64;   // threads of the env warps (2), one an env
constexpr int kThreads = kMlp + kEnvThreads;
constexpr int kTile = 64;         // envs a tile: 4 m16 row blocks
constexpr int kXP = 16 + 8;       // bf16 state rows: D padded to 16, then 8
// The float32 kernel's modes and Philox streams (offpolicy_collect.cu).
constexpr int kSac = 0, kSacDet = 1, kTd3 = 2, kTd3Det = 3;
constexpr uint32_t kEpsStream = 3u, kWarmStream = 4u, kResetStream = 5u;
// How close a pre-activation may lie to a bf16 midpoint, or to 0, before
// it is recomputed in the twin's order: tie(v) = kTieAbs + |v| kTieRel,
// chosen above the difference between the tensor cores' sum and the
// twin's FMA chain (up to 256 products of bf16 operands, each exact in
// float32) that the probe measured, not a bound on it: that difference
// grows with the sum of the products' magnitudes, not with |v|.
constexpr float kTieAbs = 1.0f / (1 << 19);
constexpr float kTieRel = 1.0f / (1 << 18);

// Named barriers (0 is __syncthreads), as the float32 kernel's: the MLP
// warps among themselves, and READY / FREE for each of the two head-output
// buffers.
constexpr int kBarMlp = 1, kBarReady = 2, kBarFree = 4;
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// The widths of a launch: the layers' (h1, h2), L1's columns and L2's
// depth (k1: h1 rounded up to 16), L2's columns and the head's units (n2:
// h2 rounded up to 32), and the bf16 row strides (s1 = k1 + 8 for W1 and
// h1, s2 = n2 + 8 for W2 and h2: an odd number of 16-byte groups, so that
// the 8 rows of an ldmatrix fall on distinct banks).
struct Widths {
  int h1, h2, k1, n2, s1, s2;
};

__host__ __device__ inline Widths widths(int h1, int h2) {
  const int k1 = (h1 + 15) / 16 * 16, n2 = (h2 + 31) / 32 * 32;
  return {h1, h2, k1, n2, k1 + 8, n2 + 8};
}

// Byte offsets of the dynamic shared memory, each 16-byte aligned.
struct Smem {
  int w2, w1, h1, h2, x, w3, b1, b2, b3, outs, fix, bytes;
};

__host__ __device__ inline int aligned16(int n) { return (n + 15) / 16 * 16; }

__host__ __device__ inline Smem smem_layout(const Widths& w, int out) {
  Smem m{};
  int at = 0;
  m.w2 = at, at += aligned16(w.k1 * w.s2 * 2);         // (k1, s2) bf16, (in, out)
  m.w1 = at, at += aligned16(16 * w.s1 * 2);           // (16, s1) bf16, (in, out)
  m.h1 = at, at += aligned16(kTile * w.s1 * 2);        // (env, unit) bf16
  m.h2 = at, at += aligned16(kTile * w.s2 * 2);
  m.x = at, at += aligned16(kTile * kXP * 2);          // (env, state dim) bf16
  m.w3 = at, at += aligned16(out * w.n2 * 4);          // (column, unit) float32
  m.b1 = at, at += aligned16(w.k1 * 4);
  m.b2 = at, at += aligned16(w.n2 * 4);
  m.b3 = at, at += aligned16(8 * 4);
  m.outs = at, at += aligned16(2 * out * kTile * 4);   // 2 buffers of (column, env)
  m.fix = at, at += kMlp / 32 * 32 * 4;                // each MLP warp's 32 words (fix_edges)
  m.bytes = at;
  return m;
}

struct Actor {
  const float* w1;  // (D, H1)
  const float* b1;  // (H1,)
  const float* w2;  // (H1, H2)
  const float* b2;  // (H2,)
  const float* w3;  // (H2, OUT)
  const float* b3;  // (OUT,)
};

// Launches the bf16 instance of kind `env_kind` (env_kinds.cuh) and
// `mode`, or with `probe` (modes sac and td3) its probe, on `st`: one
// persistent CTA an SM.  Returns a CUDA error code.  Defined in
// offpolicy_collect_bf16.cu.
cudaError_t launch(int env_kind, int mode, const float* params_host, const float* s_in,
                   int64_t batch, int hidden1, int hidden2, const Actor& w, const float* consts,
                   uint32_t seed, float* s_out, float* block, unsigned* probe, cudaStream_t st);

__device__ __forceinline__ float tie(float v) { return kTieAbs + fabsf(v) * kTieRel; }

// Whether a pre-activation v lies near enough to 0 or to a bf16 midpoint
// that another order of summation could change relu(v)'s bf16.  Bitwise
// operators, not && and ||: nvcc turned the short-circuits into a branch a
// value, and the test runs on every output.
__device__ __forceinline__ bool near_edge(float v) {
  return (fabsf(v) <= kTieAbs) | ((v > 0.0f) & (tc::midpoint_distance(v) <= tie(v)));
}

// A layer's epilogue for the warp's block (rows r0 .. r0 + 15, n16 tiles
// col0 / 16 + j for j < np, accumulators c[2 j + h]): the bias added
// (c keeps the pre-activations), relu(pre) rounded to bf16 and stored to
// `rows`; returns the slots (4 nt + i, nt = 2 j + h) near an edge, past
// the layer's width `width` none.
__device__ __forceinline__ uint64_t relu_store(float (&c)[16][4], const float* bias, int width,
                                               bf16* rows, int stride, int r0, int col0, int np,
                                               int lane) {
  const int g = lane >> 2, q = lane & 3;
  uint64_t near = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    if (j >= np) break;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int nt = 2 * j + h, col = col0 + 8 * nt + 2 * q;
      float v[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        c[nt][i] += bias[col + (i & 1)];
        v[i] = fmaxf(c[nt][i], 0.0f);
        const bool edge = (col + (i & 1) < width) & near_edge(c[nt][i]);
        near |= static_cast<uint64_t>(edge) << (4 * nt + i);
      }
      tc::st_pair(rows + (r0 + g) * stride + col, tc::pack(v[0], v[1]));
      tc::st_pair(rows + (r0 + g + 8) * stride + col, tc::pack(v[2], v[3]));
    }
  }
  return near;
}

// The units of the warp's slots `near` recomputed by unit(row, column)
// (the twin's sum from 0 over the inputs), the bias added, and relu of
// that stored, rounded to bf16, into `rows`, one a lane a pass
// (tc::for_each_flagged; `list` the warp's 32 words).
template <class Unit>
__device__ __forceinline__ void fix_edges(uint64_t near, const float* bias, bf16* rows, int stride,
                                          int r0, int col0, uint32_t* list, int lane,
                                          Unit&& unit) {
  tc::for_each_flagged(near, list, lane, [&](int owner, int slot) {
    const int row = r0 + tc::acc_row(owner, slot & 3);
    const int col = col0 + 8 * (slot >> 2) + tc::acc_col(owner, slot & 3);
    rows[row * stride + col] = __float2bfloat16_rn(fmaxf(unit(row, col) + bias[col], 0.0f));
  });
}

// The probe's check of one layer's block: every unit of a valid row and
// column recomputed in the twin's order, the misses counted, the largest
// |pre - twin's| / tie(twin's) kept.
template <class Unit>
__device__ __forceinline__ void probe_layer(const float (&c)[16][4], uint64_t near,
                                            const float* bias, int width, int valid_rows, int r0,
                                            int col0, int np, int lane, Unit&& unit,
                                            unsigned& redone, unsigned& missed, float& worst) {
#pragma unroll 1  // one copy of unit's code: the probe's build time, not its speed
  for (int nt = 0; nt < 16; ++nt) {
    if (nt >= 2 * np) break;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = r0 + tc::acc_row(lane, i), col = col0 + 8 * nt + tc::acc_col(lane, i);
      if (row >= valid_rows || col >= width) continue;
      const float twin = unit(row, col) + bias[col];
      worst = fmaxf(worst, fabsf(c[nt][i] - twin) / tie(twin));
      const bool fixed = (near >> (4 * nt + i)) & 1u;
      redone += fixed;
      missed += !fixed && tc::round_bf16(fmaxf(twin, 0.0f)) != tc::round_bf16(fmaxf(c[nt][i], 0.0f));
    }
  }
}

// The head of the twin's chunk fold on one chunk of 32 units: h the bf16
// h2 units as float32, w the column's weights (bf16 values).
__device__ __forceinline__ float chunk_fold(const float (&h)[32], const float* w) {
  float run[8];
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const float4 wv = *reinterpret_cast<const float4*>(w + 4 * r);
    float s = fmaf(h[4 * r], wv.x, 0.0f);
    s = fmaf(h[4 * r + 1], wv.y, s);
    s = fmaf(h[4 * r + 2], wv.z, s);
    run[r] = fmaf(h[4 * r + 3], wv.w, s);
  }
  const float v0 = run[0] + run[4], v1 = run[1] + run[5], v2 = run[2] + run[6],
              v3 = run[3] + run[7];
  return (v0 + v2) + (v1 + v3);
}

// The action, env step, block and reset of env g (env-warp thread te of
// the tile), a copy of the float32 kernel's phase 4 (offpolicy_collect.cu
// says why it is not shared): `s` its state, `outs` the tile's head
// outputs (column, env).
template <class Env, int kMode>
__device__ __forceinline__ void env_step(float (&s)[Env::kD], const float* __restrict__ outs,
                                         int te, int64_t g, int64_t batch,
                                         const float* __restrict__ consts, uint32_t seed,
                                         const typename Env::Params& p, float* __restrict__ s_out,
                                         float* __restrict__ block) {
  constexpr int kD = Env::kD, kA = Env::kA;
  constexpr bool kIsSac = kMode == kSac || kMode == kSacDet;
  const uint32_t env = static_cast<uint32_t>(g);
  float a_t[kA];
  if (consts[0] > 0.5f) {  // warmup: U(-1, 1) in policy space
    const uint4 b = reinmav::philox4x32_10(make_uint4(env, 0u, 0u, kWarmStream), seed, 0u);
    const uint32_t words[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int a = 0; a < kA; ++a) a_t[a] = reinmav::uniform_pm1(words[a]);
  } else {
    float eps[kA] = {};
    if (kMode == kSac || kMode == kTd3) {
      const uint4 ub = reinmav::philox4x32_10(make_uint4(env, 0u, 0u, kEpsStream), seed, 0u);
      const uint4 vb = reinmav::philox4x32_10(make_uint4(env, 0u, 1u, kEpsStream), seed, 0u);
      const uint32_t uw[4] = {ub.x, ub.y, ub.z, ub.w};
      const uint32_t vw[4] = {vb.x, vb.y, vb.z, vb.w};
#pragma unroll
      for (int a = 0; a < kA; ++a) {
        const float u = reinmav::uniform01(uw[a]);
        const float v = reinmav::uniform01(vw[a]);
        eps[a] = sqrtf(-2.0f * logf(1.0f - u)) * cosf(6.28318530717958648f * v);
      }
    }
#pragma unroll
    for (int a = 0; a < kA; ++a) {
      const float o = outs[a * kTile + te];
      if (kIsSac) {
        float uu = o;
        if (kMode == kSac) {
          const float ls = fminf(fmaxf(outs[(kA + a) * kTile + te], -20.0f), 2.0f);
          uu = o + expf(ls) * eps[a];
        }
        a_t[a] = tanhf(uu);
      } else {
        a_t[a] = tanhf(o);
        if (kMode == kTd3) a_t[a] = fminf(fmaxf(a_t[a] + consts[1] * eps[a], -1.0f), 1.0f);
      }
    }
  }
  float act[kA];
#pragma unroll
  for (int a = 0; a < kA; ++a) {
    const float lo = consts[2 + a], hi = consts[2 + kA + a];
    act[a] = lo + (a_t[a] + 1.0f) * (0.5f * (hi - lo));
  }

  // The block, in ring row order: obs, action, reward, next_obs, done.
#pragma unroll
  for (int d = 0; d < kD; ++d) block[d * batch + g] = s[d];
#pragma unroll
  for (int a = 0; a < kA; ++a) block[(kD + a) * batch + g] = a_t[a];
  bool done;
  const float raw = Env::step(s, act, p, Env::consts(p), done);
  block[(kD + kA) * batch + g] = raw;
#pragma unroll
  for (int d = 0; d < kD; ++d) block[(kD + kA + 1 + d) * batch + g] = s[d];
  block[(2 * kD + kA + 1) * batch + g] = done ? 1.0f : 0.0f;
  if (done) Env::reset(s, env, 0u, seed, kResetStream, p);
#pragma unroll
  for (int d = 0; d < kD; ++d) s_out[d * batch + g] = s[d];
}

template <class Env, int kMode, bool kProbe>
__device__ __forceinline__ void collect(const float* __restrict__ s_in, int64_t batch,
                                        const Widths wd, const Actor& w,
                                        const float* __restrict__ consts, uint32_t seed,
                                        const typename Env::Params& p, float* __restrict__ s_out,
                                        float* __restrict__ block, unsigned* __restrict__ probe) {
  constexpr int kD = Env::kD;
  constexpr bool kIsSac = kMode == kSac || kMode == kSacDet;
  constexpr int kOut = kIsSac ? 2 * Env::kA : Env::kA;
  static_assert(kD <= 16 && kOut <= 8, "L1 takes one k16 step, the head at most 8 columns");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Smem m = smem_layout(wd, kOut);
  bf16* w2s = reinterpret_cast<bf16*>(smem_raw + m.w2);
  bf16* w1s = reinterpret_cast<bf16*>(smem_raw + m.w1);
  bf16* h1s = reinterpret_cast<bf16*>(smem_raw + m.h1);
  bf16* h2s = reinterpret_cast<bf16*>(smem_raw + m.h2);
  bf16* xs = reinterpret_cast<bf16*>(smem_raw + m.x);
  float* w3s = reinterpret_cast<float*>(smem_raw + m.w3);
  float* b1s = reinterpret_cast<float*>(smem_raw + m.b1);
  float* b2s = reinterpret_cast<float*>(smem_raw + m.b2);
  float* b3s = reinterpret_cast<float*>(smem_raw + m.b3);
  float* outs = reinterpret_cast<float*>(smem_raw + m.outs);
  uint32_t* fix = reinterpret_cast<uint32_t*>(smem_raw + m.fix);

  const int tid = threadIdx.x;
  const int64_t n_env_tiles = (batch + kTile - 1) / kTile;
  const int count = blockIdx.x < n_env_tiles
                        ? static_cast<int>((n_env_tiles - 1 - blockIdx.x) / gridDim.x) + 1
                        : 0;

  // Once a CTA: the weights rounded to bf16 (W3's as float32 values), the
  // biases float32, zero past the widths.
  for (int i = tid; i < m.x / 16; i += kThreads) reinterpret_cast<uint4*>(smem_raw)[i] = uint4{};
  __syncthreads();
  if (wd.h2 % 4 == 0 && (reinterpret_cast<uintptr_t>(w.w2) & 15) == 0) {
    // W2 as float4s, 8 loads of a thread in flight before its stores.
    const int per_row = wd.h2 / 4, n4 = wd.h1 * per_row;
    for (int i0 = tid; i0 < n4; i0 += 8 * kThreads) {
      float4 v[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int i = i0 + k * kThreads;
        if (i < n4) v[k] = __ldg(reinterpret_cast<const float4*>(w.w2) + i);
      }
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int i = i0 + k * kThreads;
        if (i >= n4) break;
        const int j = i / per_row, u = 4 * (i - j * per_row);
        *reinterpret_cast<uint2*>(w2s + j * wd.s2 + u) =
            make_uint2(tc::pack(v[k].x, v[k].y), tc::pack(v[k].z, v[k].w));
      }
    }
  } else {
    for (int i = tid; i < wd.h1 * wd.h2; i += kThreads) {
      const int j = i / wd.h2, u = i - j * wd.h2;
      w2s[j * wd.s2 + u] = __float2bfloat16_rn(__ldg(w.w2 + i));
    }
  }
  for (int i = tid; i < kD * wd.h1; i += kThreads) {
    const int d = i / wd.h1, j = i - d * wd.h1;
    w1s[d * wd.s1 + j] = __float2bfloat16_rn(w.w1[i]);
  }
  for (int i = tid; i < wd.n2 * kOut; i += kThreads) {
    const int u = i / kOut, o = i - u * kOut;
    w3s[o * wd.n2 + u] = u < wd.h2 ? tc::round_bf16(w.w3[i]) : 0.0f;
  }
  for (int i = tid; i < wd.k1; i += kThreads) b1s[i] = i < wd.h1 ? w.b1[i] : 0.0f;
  for (int i = tid; i < wd.n2; i += kThreads) b2s[i] = i < wd.h2 ? w.b2[i] : 0.0f;
  if (tid < kOut) b3s[tid] = w.b3[tid];
  __syncthreads();

  if (tid < kMlp) {
    const int lane = tid & 31, warp = tid >> 5;
    const int r0 = 16 * (warp & 3), nh = warp >> 2;
    // The warp's n16 tiles of each layer: [p0, p0 + np).
    const int half1 = (wd.k1 / 16 + 1) / 2, p1 = nh * half1;
    const int np1 = max(0, min(half1, wd.k1 / 16 - p1));
    const int half2 = (wd.n2 / 16 + 1) / 2, p2 = nh * half2;
    const int np2 = max(0, min(half2, wd.n2 / 16 - p2));
    unsigned redone1 = 0, redone2 = 0, missed1 = 0, missed2 = 0;
    float worst1 = 0.0f, worst2 = 0.0f;
    for (int n = 0; n < count; ++n) {
      const int buf = n & 1;
      const int64_t e0 = (blockIdx.x + static_cast<int64_t>(n) * gridDim.x) * kTile;
      const int valid_rows = batch - e0 < kTile ? static_cast<int>(batch - e0) : kTile;
      // The tile's states as bf16 rows, zero past D and past the batch.
      for (int i = tid; i < kTile * 16; i += kMlp) {
        const int e = i & (kTile - 1), d = i / kTile;
        const float v = d < kD && e < valid_rows ? s_in[d * batch + e0 + e] : 0.0f;
        xs[e * kXP + d] = __float2bfloat16_rn(v);
      }
      bar_sync(kBarMlp, kMlp);  // the states; the last tile's rows are read

      float c[16][4];
      // L1 = x W1, then the bias and the ReLU.
      {
        uint32_t xa[4], b[8][4];
        tc::ldsm4(xa, xs + (r0 + tc::row_a(lane)) * kXP + tc::col_a(lane));
        // All 8 n16 tiles, without a branch, so that the loads go ahead of
        // the products: a tile past the warp's (j >= np1) reads tile p1
        // again, and relu_store leaves its accumulators alone.
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int pj = p1 + (j < np1 ? j : 0);
          tc::ldsm4t(b[j], w1s + tc::row_a(lane) * wd.s1 + 16 * pj + tc::col_a(lane));
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int i = 0; i < 4; ++i) c[2 * j][i] = c[2 * j + 1][i] = 0.0f;
          tc::mma(c[2 * j], xa, b[j][0], b[j][1]);
          tc::mma(c[2 * j + 1], xa, b[j][2], b[j][3]);
        }
      }
      // The twin's L1 sum: from 0 over the state dims in order.
      auto l1_unit = [&](int row, int col) {
        float z = 0.0f;
#pragma unroll
        for (int d = 0; d < kD; ++d) {
          z = fmaf(tc::to_float(xs[row * kXP + d]), tc::to_float(w1s[d * wd.s1 + col]), z);
        }
        return z;
      };
      uint64_t near = relu_store(c, b1s, wd.h1, h1s, wd.s1, r0, 16 * p1, np1, lane);
      if constexpr (kProbe) {
        probe_layer(c, near, b1s, wd.h1, valid_rows, r0, 16 * p1, np1, lane, l1_unit, redone1,
                    missed1, worst1);
      }
      fix_edges(near, b1s, h1s, wd.s1, r0, 16 * p1, fix + 32 * warp, lane, l1_unit);
      bar_sync(kBarMlp, kMlp);  // h1 complete

      // L2 = h1 W2 over the k16 steps of h1, then the bias and the ReLU.
#pragma unroll
      for (int nt = 0; nt < 16; ++nt) {
#pragma unroll
        for (int i = 0; i < 4; ++i) c[nt][i] = 0.0f;
      }
#pragma unroll 2
      for (int kk = 0; kk < wd.k1 / 16; ++kk) {
        uint32_t a[4], b[8][4];
        tc::ldsm4(a, h1s + (r0 + tc::row_a(lane)) * wd.s1 + 16 * kk + tc::col_a(lane));
#pragma unroll
        for (int j = 0; j < 8; ++j) {  // as L1: all 8 tiles, a tile past the warp's reads p2
          const int pj = p2 + (j < np2 ? j : 0);
          tc::ldsm4t(b[j], w2s + (16 * kk + tc::row_a(lane)) * wd.s2 + 16 * pj + tc::col_a(lane));
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          tc::mma(c[2 * j], a, b[j][0], b[j][1]);
          tc::mma(c[2 * j + 1], a, b[j][2], b[j][3]);
        }
      }
      // The twin's L2 sum: from 0 over h1's units in order (the padded
      // units add +0).
      auto l2_unit = [&](int row, int col) {
        float z = 0.0f;
        const bf16* hrow = h1s + row * wd.s1;
        for (int k0 = 0; k0 < wd.k1; k0 += 8) {
          const uint4 hv = *reinterpret_cast<const uint4*>(hrow + k0);
          const uint32_t hw[4] = {hv.x, hv.y, hv.z, hv.w};
#pragma unroll
          for (int k = 0; k < 8; ++k) {
            const float hk = k & 1 ? tc::hi_half(hw[k >> 1]) : tc::lo_half(hw[k >> 1]);
            z = fmaf(hk, tc::to_float(w2s[(k0 + k) * wd.s2 + col]), z);
          }
        }
        return z;
      };
      near = relu_store(c, b2s, wd.h2, h2s, wd.s2, r0, 16 * p2, np2, lane);
      if constexpr (kProbe) {
        probe_layer(c, near, b2s, wd.h2, valid_rows, r0, 16 * p2, np2, lane, l2_unit, redone2,
                    missed2, worst2);
      }
      fix_edges(near, b2s, h2s, wd.s2, r0, 16 * p2, fix + 32 * warp, lane, l2_unit);
      bar_sync(kBarMlp, kMlp);  // h2 complete

      // The head, in the twin's chunk fold, once the env warps are done
      // with this buffer.
      if (n >= 2) bar_sync(kBarFree + buf, kThreads);
      float* out = outs + buf * kOut * kTile;
      const int e = tid & (kTile - 1), o0 = tid / kTile;
      if (o0 < kOut) {
        const bool two = o0 + 4 < kOut;
        const bf16* hrow = h2s + e * wd.s2;
        float head0 = 0.0f, head1 = 0.0f;
        for (int u0 = 0; u0 < wd.n2; u0 += 32) {
          float h[32];
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const uint4 hv = *reinterpret_cast<const uint4*>(hrow + u0 + 8 * k);
            const uint32_t hw[4] = {hv.x, hv.y, hv.z, hv.w};
#pragma unroll
            for (int x = 0; x < 4; ++x) {
              h[8 * k + 2 * x] = tc::lo_half(hw[x]);
              h[8 * k + 2 * x + 1] = tc::hi_half(hw[x]);
            }
          }
          head0 = head0 + chunk_fold(h, w3s + o0 * wd.n2 + u0);
          if (two) head1 = head1 + chunk_fold(h, w3s + (o0 + 4) * wd.n2 + u0);
        }
        out[o0 * kTile + e] = head0 + b3s[o0];
        if (two) out[(o0 + 4) * kTile + e] = head1 + b3s[o0 + 4];
      }
      bar_arrive(kBarReady + buf, kThreads);  // outs of tile n are ready
    }
    if constexpr (kProbe) {
      atomicAdd(probe + 0, redone1);
      atomicAdd(probe + 1, redone2);
      atomicAdd(probe + 2, missed1);
      atomicAdd(probe + 3, missed2);
      atomicMax(probe + 4, __float_as_uint(worst1));
      atomicMax(probe + 5, __float_as_uint(worst2));
    }
  } else {
    const int te = tid - kMlp;
    for (int n = 0; n < count; ++n) {
      const int buf = n & 1;
      const int64_t g = (blockIdx.x + static_cast<int64_t>(n) * gridDim.x) * kTile + te;
      bar_sync(kBarReady + buf, kThreads);
      if (g < batch) {
        float s[kD];
#pragma unroll
        for (int d = 0; d < kD; ++d) s[d] = s_in[d * batch + g];
        env_step<Env, kMode>(s, outs + buf * kOut * kTile, te, g, batch, consts, seed, p, s_out,
                             block);
      }
      if (n + 2 < count) bar_arrive(kBarFree + buf, kThreads);  // the MLP warps may refill
    }
  }
}

}  // namespace offpolicy_bf16
}  // namespace reinmav
