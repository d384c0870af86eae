// K7 wide: the fused off-policy collection step of SAC, TD3 and DDPG for an
// actor whose hidden layers are each from 1 to 1024 units wide (the narrow
// instances of offpolicy_collect.cu take each from 1 to 256), written for
// NVIDIA Hopper (sm_90a), float32; its bf16 counterpart is
// offpolicy_collect_wide_bf16.cu, launched through the same entry points.
//
// Replaces, past 256 units a layer, reinmav_tpu/ops/pallas_offpolicy.py::
// collect_step_pallas (:155, pallas_call :206), the grid step _kernel
// (:71-148), which keeps W1, W2 and W3 whole in VMEM at any width
// (:193-198): TD3's and DDPG's 400-300 actor, SAC at 512 and 1024.  Every
// kind of env_kinds.cuh and every mode, as the narrow instances.  Its plain
// twin is reinmav_tpu_torch/ops/offpolicy.py::collect_step_reference.
//
// What bounds it on the card: arithmetic.  Per env the MLP is 2 (D H1 + H1
// H2 + H2 OUT) FP32 operations: 250,400 at TD3's (10, 400, 300, 4), 545,792
// at SAC's (13, 512, 512, 8), 2,140,160 at (13, 1024, 1024, 8), against
// about 232 B of states and block.  At 65,536 envs and 67 TFLOP/s that is
// 0.245, 0.534 and 2.093 ms.
//
// The design is the narrow instance's (a persistent CTA of 8 MLP warps and
// 4 env warps, one CTA an SM, the tile's states and head outputs
// double-buffered between them; 8-unit x 8-env register tiles over j in
// order; W2 through a three-slot cp.async ring), with the env tile chosen
// by the widths (F32Plan): at H1 = 1024 the tile's h1 is 1024 x 128
// floats, 512 KB, against a CTA's 227 KB, so the tile shrinks to 64 envs
// past H1 = 256 and to 32 past 512, h1 staying within 128 KB.  A smaller
// tile keeps each thread's 8 x 8 register tile (64 FFMA to 4 LDS.128 a j):
// a pass covers 16384 / tile units (128, 256 or 512), each MLP thread one
// 128-unit sub-pass sp and one 8-env group eg, so that the W2 ring tile
// (4096 floats: 32, 16 or 8 rows) grows as wide as the pass.  W1, W3 and
// the biases, which the narrow instance staged whole in shared memory (W1
// alone is 64 KB at D = 16, H1 = 1024), are read from global memory
// through the L1 (phase 2 and the head's fold, a few hundredths of the
// work).  Shared memory: at most 221,184 B (tile 128, D 16, OUT 8); 202,752
// at H1 = 1024.
//
// Every (unit, env) sum keeps the narrow instance's order: phase 2 over d,
// phase 3 over j in order from 0 (zero rows past H1 add +0 to a sum that is
// never -0), the head's fold of each 32-unit chunk (its groups g and g + 4
// in the thread, then xor-shuffles 2 and 1 across the chunk's four lanes)
// and the chunks added in order from 0, then b3.  So forced at widths the
// narrow instance takes, the wide instance gives its bits.  No atomics: a
// rerun is bitwise equal.  FP32 FMAs only.  The counting kernel (the taut
// counts of the slung kinds, on no training path) has no wide instance.

#include <cuda_runtime.h>
#include <stdint.h>

#include "env_kinds.cuh"
#include "offpolicy_collect_wide.cuh"

namespace {

namespace ow = reinmav::offpolicy_wide;
using ow::Actor;
using ow::F32Plan;
using ow::bar_arrive;
using ow::bar_sync;
using ow::kBarFree;
using ow::kBarMlp;
using ow::kBarReady;

constexpr int kMlp = 256;         // threads of the MLP warps (8)
constexpr int kEnvThreads = 128;  // threads of the env warps (4), one an env
constexpr int kThreads = kMlp + kEnvThreads;
constexpr int kSlotFloats = 4096;  // a ring tile: rows x pass floats
constexpr int kSlots = 3;          // ring tiles
constexpr int kChunk = 32;         // units per chunk of the head's fold
constexpr int kSub = 128;          // units of a sub-pass (the narrow instance's pass)

// Dynamic shared memory, in floats: x (2, D, tile), h1 (k1, tile), the
// ring (kSlots, kSlotFloats), the chunk sums (pass / 32, OUT, tile), out
// (2, OUT, tile).  Every array starts 16-byte aligned.
inline size_t smem_floats(int d, const F32Plan& p, int out) {
  const size_t t = static_cast<size_t>(p.tile);
  return 2 * d * t + static_cast<size_t>(p.k1) * t + kSlots * kSlotFloats +
         static_cast<size_t>(p.pass / kChunk) * out * t + 2 * out * t;
}

__device__ __forceinline__ void copy4(float* dst, const float* src, int src_bytes) {
  const unsigned int d = static_cast<unsigned int>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void copy_wait_all_but_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Where column u (0-127) of a sub-pass lands in the ring's rows: the narrow
// instance's pass_pos (column 32 c + 16 h + 4 g + k at 64 h + 16 c + 4 g +
// k), so that a thread's two groups are the float4s at 4 (4 c + g) and 64
// + that.
__device__ __forceinline__ int pass_pos(int u) {
  return 64 * ((u >> 4) & 1) + 16 * (u >> 5) + (u & 15);
}

// The W2 tile of rows j0 .. j0 + rows - 1 and columns u0 .. u0 + pass - 1
// into `slot` (rows of `pass`, each sub-pass permuted by pass_pos), zero
// past the widths: element tid + kMlp n, row-major.
__device__ __forceinline__ void copy_tile(float* slot, const float* __restrict__ w2, int j0,
                                          int u0, const F32Plan& pl, int shift, int tid) {
#pragma unroll 4
  for (int n = 0; n < kSlotFloats / kMlp; ++n) {
    const int i = tid + n * kMlp;
    const int r = i >> shift, u = i & (pl.pass - 1);
    const bool ok = j0 + r < pl.h1 && u0 + u < pl.h2;
    copy4(slot + r * pl.pass + (u & ~(kSub - 1)) + pass_pos(u & (kSub - 1)),
          ok ? w2 + static_cast<int64_t>(j0 + r) * pl.h2 + u0 + u : w2, ok ? 4 : 0);
  }
}

// Phases 1-3 of one tile for the MLP warps (tid < kMlp): its states into
// `x` (zero past the batch), h1, h2 through the W2 ring and the fold into
// the head outputs `outs`.  Local iteration n of the CTA, buffer `buf`.
template <class Env, int kMode>
__device__ __forceinline__ void mlp_tile(const float* __restrict__ s_in, int64_t batch,
                                         int64_t e0, int n, int buf, const F32Plan& pl,
                                         const Actor& w, float* __restrict__ x,
                                         float* __restrict__ h1, float* __restrict__ ring,
                                         float* __restrict__ sums, float* __restrict__ outs,
                                         int tid) {
  constexpr int kD = Env::kD, kA = Env::kA;
  constexpr bool kIsSac = kMode == ow::kSac || kMode == ow::kSacDet;
  constexpr int kOut = kIsSac ? 2 * kA : kA;
  const int T = pl.tile, shift = __ffs(pl.pass) - 1;
  const int egs = T / 8;  // 8-env groups of the tile
  const int per_pass = pl.k1 / pl.rows;
  const int n_tiles = pl.n_pass * per_pass;

  // 1. The ring's first two tiles in flight; the tile's states (zero past
  // the batch) into its buffer once the env warps are done with it.
  int next_j = 0, next_p = 0;  // the next tile to copy: its row tile and pass
#pragma unroll
  for (int t = 0; t < kSlots - 1; ++t) {
    if (t < n_tiles) {
      copy_tile(ring + t * kSlotFloats, w.w2, next_j * pl.rows, next_p * pl.pass, pl, shift,
                tid);
      if (++next_j == per_pass) next_j = 0, ++next_p;
    }
    ow::copy_commit();
  }
  if (n >= 2) bar_sync(kBarFree + buf, kThreads);  // the env warps are done with x, outs
  for (int i = tid; i < kD * T; i += kMlp) {
    const int d = i / T;
    const int64_t g = e0 + i % T;
    x[i] = g < batch ? s_in[d * batch + g] : 0.0f;
  }
  bar_sync(kBarMlp, kMlp);

  // 2. h1 = relu(W1^T x + b1) over units 0 .. k1 - 1 (zero past H1): item
  // it of (k1 / 8) x egs, units 8 (it / egs) + i, envs 8 (it % egs) + e.
  for (int it = tid; it < (pl.k1 / 8) * egs; it += kMlp) {
    const int u0 = 8 * (it / egs), e0x = 8 * (it % egs);
    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[i][e] = 0.0f;
#pragma unroll
    for (int d = 0; d < kD; ++d) {
      float wv[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        wv[i] = u0 + i < pl.h1 ? __ldg(w.w1 + d * pl.h1 + u0 + i) : 0.0f;
      }
      const float4 xa = *reinterpret_cast<const float4*>(&x[d * T + e0x]);
      const float4 xb = *reinterpret_cast<const float4*>(&x[d * T + e0x + 4]);
      const float xv[8] = {xa.x, xa.y, xa.z, xa.w, xb.x, xb.y, xb.z, xb.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[i][e] += wv[i] * xv[e];
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float b = u0 + i < pl.h1 ? __ldg(w.b1 + u0 + i) : 0.0f;
      float4 lo, hi;
      lo.x = fmaxf(acc[i][0] + b, 0.0f);
      lo.y = fmaxf(acc[i][1] + b, 0.0f);
      lo.z = fmaxf(acc[i][2] + b, 0.0f);
      lo.w = fmaxf(acc[i][3] + b, 0.0f);
      hi.x = fmaxf(acc[i][4] + b, 0.0f);
      hi.y = fmaxf(acc[i][5] + b, 0.0f);
      hi.z = fmaxf(acc[i][6] + b, 0.0f);
      hi.w = fmaxf(acc[i][7] + b, 0.0f);
      *reinterpret_cast<float4*>(&h1[(u0 + i) * T + e0x]) = lo;
      *reinterpret_cast<float4*>(&h1[(u0 + i) * T + e0x + 4]) = hi;
    }
  }

  // 3. h2 = relu(W2^T h1 + b2) a pass at a time, W2 through the ring,
  // folded into the head after each pass.  Thread (lane, warp): unit group
  // ug = lane % 16 of sub-pass sp (chunk ug / 4 of it, group g = ug % 4 and
  // g + 4), envs 8 eg .. 8 eg + 7, (sp, eg) from c = lane / 16 + 2 warp.
  {
  const int lane = tid % 32;
  const int ug = lane % 16, g = ug % 4, cl = ug / 4;
  const int c = lane / 16 + 2 * (tid / 32);
  const int eg = c % egs, sp = c / egs;
  float acc[8][8];  // [group A units 0-3, group B units 0-3][env]
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[i][e] = 0.0f;
  int tile_j = 0, pass = 0, slot_i = 0;  // tile t's row tile, pass and ring slot
  for (int t = 0; t < n_tiles; ++t) {
    copy_wait_all_but_one();
    bar_sync(kBarMlp, kMlp);  // tile t everyone's; h1 complete; tile t - 1's slot consumed
    if (t + kSlots - 1 < n_tiles) {
      const int s2 = slot_i == 0 ? kSlots - 1 : slot_i - 1;  // (t + kSlots - 1) % kSlots
      copy_tile(ring + s2 * kSlotFloats, w.w2, next_j * pl.rows, next_p * pl.pass, pl, shift,
                tid);
      if (++next_j == per_pass) next_j = 0, ++next_p;
    }
    ow::copy_commit();
    const float* slot = ring + slot_i * kSlotFloats + kSub * sp + 4 * ug;
    const float* hrow = h1 + tile_j * pl.rows * T + 8 * eg;
    slot_i = slot_i == kSlots - 1 ? 0 : slot_i + 1;
#pragma unroll 8
    for (int jj = 0; jj < pl.rows; ++jj) {
      const float4 wa = *reinterpret_cast<const float4*>(&slot[jj * pl.pass]);
      const float4 wb = *reinterpret_cast<const float4*>(&slot[jj * pl.pass + 64]);
      const float4 ha = *reinterpret_cast<const float4*>(&hrow[jj * T]);
      const float4 hb = *reinterpret_cast<const float4*>(&hrow[jj * T + 4]);
      const float wk[8] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
      const float he[8] = {ha.x, ha.y, ha.z, ha.w, hb.x, hb.y, hb.z, hb.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[i][e] += wk[i] * he[e];
    }
    if (++tile_j < per_pass) continue;
    tile_j = 0;

    // The pass is done: fold its chunks into the head.  Thread ug's units
    // are u0 + k (group A) and u0 + 16 + k (group B), u0 = pass x pass +
    // 128 sp + 32 cl + 4 g; b2 and W3 from global memory, zero past H2.
    const int u0 = pass * pl.pass + kSub * sp + kChunk * cl + 4 * g;
    {
      float b[8];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        b[k] = u0 + k < pl.h2 ? __ldg(w.b2 + u0 + k) : 0.0f;
        b[4 + k] = u0 + 16 + k < pl.h2 ? __ldg(w.b2 + u0 + 16 + k) : 0.0f;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[i][e] = fmaxf(acc[i][e] + b[i], 0.0f);
    }
#pragma unroll
    for (int o = 0; o < kOut; ++o) {
      float w3a[4], w3b[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        w3a[k] = u0 + k < pl.h2 ? __ldg(w.w3 + (u0 + k) * kOut + o) : 0.0f;
        w3b[k] = u0 + 16 + k < pl.h2 ? __ldg(w.w3 + (u0 + 16 + k) * kOut + o) : 0.0f;
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        float pa = 0.0f, pb = 0.0f;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          pa += w3a[k] * acc[k][e];
          pb += w3b[k] * acc[4 + k][e];
        }
        float v = pa + pb;
        v += __shfl_xor_sync(0xFFFFFFFFu, v, 2);
        v += __shfl_xor_sync(0xFFFFFFFFu, v, 1);
        if (g == 0) sums[((4 * sp + cl) * kOut + o) * T + 8 * eg + e] = v;
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[i][e] = 0.0f;
    bar_sync(kBarMlp, kMlp);
    // The head: the pass's chunks added in chunk order (from 0 in pass 0).
    for (int i = tid; i < kOut * T; i += kMlp) {
      float head = pass == 0 ? 0.0f : outs[i];
      const int o = i / T, e = i % T;
      for (int cc = 0; cc < pl.pass / kChunk && pass * (pl.pass / kChunk) + cc < pl.chunks;
           ++cc) {
        head += sums[(cc * kOut + o) * T + e];
      }
      outs[i] = t == n_tiles - 1 ? head + __ldg(w.b3 + o) : head;
    }
    ++pass;
  }
  }
}

// A persistent CTA walks the tiles blockIdx.x, + gridDim.x, ...: its 8 MLP
// warps run phases 1-3 of tile n while its 4 env warps run phase 4 of tile
// n - 1, the states and head outputs double-buffered between them.
template <class Env, int kMode>
__global__ void __launch_bounds__(kThreads, 1)
offpolicy_collect_wide_kernel(const float* __restrict__ s_in, int64_t batch, F32Plan pl, Actor w,
                              const float* __restrict__ consts, uint32_t seed,
                              typename Env::Params p, float* __restrict__ s_out,
                              float* __restrict__ block) {
  constexpr int kD = Env::kD, kA = Env::kA;
  constexpr bool kIsSac = kMode == ow::kSac || kMode == ow::kSacDet;
  constexpr int kOut = kIsSac ? 2 * kA : kA;
  extern __shared__ __align__(16) float smem[];
  const int T = pl.tile;
  float* xs = smem;  // 2 x (D, T)
  float* h1 = xs + 2 * kD * T;
  float* ring = h1 + pl.k1 * T;
  float* sums = ring + kSlots * kSlotFloats;
  float* outs = sums + (pl.pass / kChunk) * kOut * T;  // 2 x (OUT, T)

  const int tid = threadIdx.x;
  const int64_t n_env_tiles = (batch + T - 1) / T;
  const int count = blockIdx.x < n_env_tiles
                        ? static_cast<int>((n_env_tiles - 1 - blockIdx.x) / gridDim.x) + 1
                        : 0;
  if (tid < kMlp) {
    for (int n = 0; n < count; ++n) {
      const int buf = n & 1;
      const int64_t e0 = (blockIdx.x + static_cast<int64_t>(n) * gridDim.x) * T;
      mlp_tile<Env, kMode>(s_in, batch, e0, n, buf, pl, w, xs + buf * kD * T, h1, ring, sums,
                           outs + buf * kOut * T, tid);
      bar_arrive(kBarReady + buf, kThreads);  // x and outs of tile n are ready
    }
  } else {
    const int te = tid - kMlp;
    for (int n = 0; n < count; ++n) {
      const int buf = n & 1;
      const int64_t g = (blockIdx.x + static_cast<int64_t>(n) * gridDim.x) * T + te;
      bar_sync(kBarReady + buf, kThreads);
      if (te < T && g < batch) {
        const float* x = xs + buf * kD * T;
        float s[kD];
#pragma unroll
        for (int d = 0; d < kD; ++d) s[d] = x[d * T + te];
        ow::env_step<Env, kMode>(s, outs + buf * kOut * T, T, te, g, batch, consts, seed, p,
                                 s_out, block);
      }
      if (n + 2 < count) bar_arrive(kBarFree + buf, kThreads);  // the MLP warps may refill
    }
  }
}

// A float32 launch of kind Env, mode kMode and plan pl: allows its shared
// memory and, with a stream, launches; else, with `ctas`, stores its
// resident CTAs an SM and `smem` its dynamic shared memory.
template <class Env, int kMode>
cudaError_t launch_mode(const float* s_in, int64_t batch, const F32Plan& pl, const Actor& w,
                        const float* consts, uint32_t seed, const float* params_host,
                        float* s_out, float* block, cudaStream_t st, int* ctas, long long* smem) {
  constexpr int kOut = (kMode == ow::kSac || kMode == ow::kSacDet) ? 2 * Env::kA : Env::kA;
  const size_t bytes = smem_floats(Env::kD, pl, kOut) * sizeof(float);
  int device = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return e;
  auto kernel = offpolicy_collect_wide_kernel<Env, kMode>;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(bytes));
  if (e != cudaSuccess) return e;
  if (ctas != nullptr) {
    *smem = static_cast<long long>(bytes);
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas, kernel, kThreads, bytes);
  }
  // Persistent CTAs, one an SM (or one a tile where there are fewer).
  const int64_t tiles = (batch + pl.tile - 1) / pl.tile;
  const auto blocks = static_cast<unsigned int>(tiles < sms ? tiles : sms);
  kernel<<<blocks, kThreads, bytes, st>>>(s_in, batch, pl, w, consts, seed,
                                          Env::params(params_host), s_out, block);
  return cudaGetLastError();
}

template <class Env>
cudaError_t launch_env(int mode, const float* s_in, int64_t batch, const F32Plan& pl,
                       const Actor& w, const float* consts, uint32_t seed,
                       const float* params_host, float* s_out, float* block, cudaStream_t st,
                       int* ctas, long long* smem) {
  switch (mode) {
    case ow::kSac:
      return launch_mode<Env, ow::kSac>(s_in, batch, pl, w, consts, seed, params_host, s_out,
                                        block, st, ctas, smem);
    case ow::kSacDet:
      return launch_mode<Env, ow::kSacDet>(s_in, batch, pl, w, consts, seed, params_host, s_out,
                                           block, st, ctas, smem);
    case ow::kTd3:
      return launch_mode<Env, ow::kTd3>(s_in, batch, pl, w, consts, seed, params_host, s_out,
                                        block, st, ctas, smem);
    case ow::kTd3Det:
      return launch_mode<Env, ow::kTd3Det>(s_in, batch, pl, w, consts, seed, params_host, s_out,
                                           block, st, ctas, smem);
    default:
      return cudaErrorInvalidValue;
  }
}

bool widths_ok(int hidden1, int hidden2) {
  return hidden1 >= 1 && hidden1 <= ow::kMaxHidden && hidden2 >= 1 && hidden2 <= ow::kMaxHidden;
}

// Every entry point below: a launch (stream), the probe (probe non-null) or
// the occupancy query (ctas non-null).
int dispatch(int env_kind, int mode, int bf16, const void* params_host, int n_params,
             const void* states_in, long long batch, int hidden1, int hidden2, const void* w1,
             const void* b1, const void* w2, const void* b2, const void* w3, const void* b3,
             const void* consts, unsigned int seed, void* states_out, void* block,
             const void* scratch, void* probe, void* stream, int* ctas, long long* smem) {
  if (batch <= 0 || !widths_ok(hidden1, hidden2)) return static_cast<int>(cudaErrorInvalidValue);
  const Actor w{static_cast<const float*>(w1), static_cast<const float*>(b1),
                static_cast<const float*>(w2), static_cast<const float*>(b2),
                static_cast<const float*>(w3), static_cast<const float*>(b3)};
  const auto* s_in = static_cast<const float*>(states_in);
  const auto* c = static_cast<const float*>(consts);
  const auto* h = static_cast<const float*>(params_host);
  auto* s_out = static_cast<float*>(states_out);
  auto* blk = static_cast<float*>(block);
  const auto st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = reinmav::with_env_kind(env_kind, [&](auto env) {
    using Env = decltype(env);
    if (ctas == nullptr && n_params != Env::kParams) return cudaErrorInvalidValue;
    if (bf16) {
      if (ctas == nullptr && scratch == nullptr) return cudaErrorInvalidValue;
      return ow::launch_bf16(Env::kKind, mode, h, s_in, batch, hidden1, hidden2, w, c, seed, s_out,
                             blk, scratch, static_cast<unsigned*>(probe), st, ctas, smem);
    }
    if (probe != nullptr) return cudaErrorInvalidValue;
    return launch_env<Env>(mode, s_in, batch, ow::f32_plan(hidden1, hidden2), w, c, seed, h,
                           s_out, blk, st, ctas, smem);
  });
  return static_cast<int>(err);
}

}  // namespace

// C interface, bound with ctypes (reinmav_tpu_torch/_build.py).  Launches on
// the given stream, does not synchronise, and returns a CUDA error code.
// The arguments of offpolicy_collect_launch (offpolicy_collect.cu) without
// the counts, with hidden1 and hidden2 each from 1 to 1024, and scratch:
// the bf16 instance's packed weights as offpolicy_collect_wide_bf16_pack_launch
// left them on this stream (null in float32).  bf16 nonzero: the wide bf16
// instance.  Any other kind, mode, width or number of params is refused with
// cudaErrorInvalidValue and nothing runs.
extern "C" int offpolicy_collect_wide_launch(int env_kind, int mode, int bf16,
                                             const void* params_host, int n_params,
                                             const void* states_in, long long batch, int hidden1,
                                             int hidden2, const void* w1, const void* b1,
                                             const void* w2, const void* b2, const void* w3,
                                             const void* b3, const void* consts,
                                             unsigned int seed, void* states_out, void* block,
                                             const void* scratch, void* stream) {
  return dispatch(env_kind, mode, bf16, params_host, n_params, states_in, batch, hidden1, hidden2,
                  w1, b1, w2, b2, w3, b3, consts, seed, states_out, block, scratch, nullptr,
                  stream, nullptr, nullptr);
}

// The wide bf16 instance's pack: the actor of `d` inputs (1 to 16), widths
// hidden1 and hidden2 (1 to 1024) and `out` head columns (1 to 8) into
// `scratch` (offpolicy_collect_wide_scratch_bytes bytes on the device), the
// layouts the wide bf16 launch and its probe read (Bf16Pack).  Refuses
// other shapes with cudaErrorInvalidValue.
extern "C" int offpolicy_collect_wide_bf16_pack_launch(int d, int hidden1, int hidden2, int out,
                                                       const void* w1, const void* b1,
                                                       const void* w2, const void* b2,
                                                       const void* w3, void* scratch,
                                                       void* stream) {
  if (d < 1 || d > 16 || out < 1 || out > 8 || !widths_ok(hidden1, hidden2) ||
      scratch == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Actor w{static_cast<const float*>(w1), static_cast<const float*>(b1),
                static_cast<const float*>(w2), static_cast<const float*>(b2),
                static_cast<const float*>(w3), nullptr};
  return static_cast<int>(ow::launch_bf16_pack(d, out, hidden1, hidden2, w, scratch,
                                               static_cast<cudaStream_t>(stream)));
}

// The wide bf16 instance's probe (no training path launches it):
// offpolicy_collect_wide_launch's arguments in mode 0 (sac) or 2 (td3),
// bf16, and `probe`, 6 uint32 on the device, zeroed by the caller, to
// which the launch adds the units of L1 and L2 recomputed in the twin's
// order and their misses, and takes the largest |sum - twin's| /
// tie(twin's) of each layer (float bits), L2's tie scaled by
// l2_tie_scale(hidden1).  Its outputs are the wide bf16 instance's.
extern "C" int offpolicy_collect_wide_bf16_probe_launch(
    int env_kind, int mode, const void* params_host, int n_params, const void* states_in,
    long long batch, int hidden1, int hidden2, const void* w1, const void* b1, const void* w2,
    const void* b2, const void* w3, const void* b3, const void* consts, unsigned int seed,
    void* states_out, void* block, const void* scratch, void* probe, void* stream) {
  if (probe == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return dispatch(env_kind, mode, 1, params_host, n_params, states_in, batch, hidden1, hidden2,
                  w1, b1, w2, b2, w3, b3, consts, seed, states_out, block, scratch, probe,
                  stream, nullptr, nullptr);
}

// The bytes of scratch the wide bf16 instance's packed weights take at
// these widths and head columns (0 for widths it refuses).
extern "C" int offpolicy_collect_wide_scratch_bytes(int hidden1, int hidden2, int out) {
  if (!widths_ok(hidden1, hidden2) || out < 1 || out > 8) return 0;
  return static_cast<int>(ow::bf16_pack(ow::bf16_plan(hidden1, hidden2), out).bytes);
}

// The wide instance of this kind, mode, dtype and widths: its resident CTAs
// an SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor, after its shared
// memory is allowed) into *ctas, its dynamic shared memory in bytes into
// *smem_bytes and its env tile (float32: 128, 64 or 32; bf16: 64) into
// *tile.  Returns a CUDA error code; refuses what the launch refuses.
extern "C" int offpolicy_collect_wide_occupancy(int env_kind, int mode, int bf16, int hidden1,
                                                int hidden2, int* ctas, long long* smem_bytes,
                                                int* tile) {
  if (ctas == nullptr || smem_bytes == nullptr || tile == nullptr || !widths_ok(hidden1, hidden2)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  *tile = bf16 ? ow::kBfTile : ow::f32_plan(hidden1, hidden2).tile;
  return dispatch(env_kind, mode, bf16, nullptr, 0, nullptr, 1, hidden1, hidden2, nullptr,
                  nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, 0u, nullptr, nullptr,
                  nullptr, nullptr, nullptr, ctas, smem_bytes);
}
