// What K7's wide instances share (offpolicy_collect_wide.cu, float32;
// offpolicy_collect_wide_bf16.cu, bf16): the plans that pick a launch's env
// tile from its widths, the actor, phase 4 (the action, the env step, the
// block and the reset of one env) with the head outputs at a run-time
// stride, and the bf16 instance's launches (its pack, then its body).  The
// narrow instances (each layer from 1 to 256: offpolicy_collect.cu,
// offpolicy_collect_bf16.cuh) include none of it and stay as they were.
//
// The wide instances take each hidden layer from 1 to 1024 units, as the
// TPU kernel takes an actor of any two widths (reinmav_tpu/ops/
// pallas_offpolicy.py::collect_step_pallas :155, W1, W2 and W3 whole in
// VMEM, :193-198).  What changes past 256 on the card is what a CTA's 227
// KB of shared memory holds: the tile's h1 (units x envs) grows with H1, so
// the env tile shrinks as H1 grows (float32: 128, 64 or 32 envs; bf16: 64),
// and the weights that the narrow instances staged whole (float32: W1, W3
// and the biases; bf16: W2) are read from global memory or streamed.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "env_kinds.cuh"

namespace reinmav {
namespace offpolicy_wide {

constexpr int kMaxHidden = 1024;
// The float32 and bf16 kernels' modes and Philox streams (offpolicy_collect.cu).
constexpr int kSac = 0, kSacDet = 1, kTd3 = 2, kTd3Det = 3;
constexpr uint32_t kEpsStream = 3u, kWarmStream = 4u, kResetStream = 5u;

struct Actor {
  const float* w1;  // (D, H1)
  const float* b1;  // (H1,)
  const float* w2;  // (H1, H2)
  const float* b2;  // (H2,)
  const float* w3;  // (H2, OUT)
  const float* b3;  // (OUT,)
};

__host__ __device__ inline int round_up(int n, int m) { return (n + m - 1) / m * m; }

// The float32 instance's plan: env tile `tile` (128 while H1 <= 256, 64 to
// 512, 32 to 1024, so that h1, k1 x tile floats, stays within 128 KB);
// layer-2 units a pass `pass` = 16384 / tile (each MLP thread an 8-unit x
// 8-env register tile: 256 threads x 64 = pass x tile); W2 rows a ring tile
// `rows` = 4096 / pass (a ring tile is 16 KB at every tile); k1 = H1 rounded
// up to a ring tile (h1's rows, layer 2's extent in j); n_pass passes
// over H2; the head's chunks of 32 units.
struct F32Plan {
  int h1, h2, tile, pass, rows, k1, n_pass, chunks;
};

__host__ __device__ inline F32Plan f32_plan(int h1, int h2) {
  const int tile = h1 <= 256 ? 128 : h1 <= 512 ? 64 : 32;
  const int pass = 16384 / tile, rows = 4096 / pass;
  return {h1, h2, tile, pass, rows, round_up(h1, rows), (h2 + pass - 1) / pass, (h2 + 31) / 32};
}

// The bf16 instance's plan: tiles of 64 envs (4 m16 row blocks); layer 1
// in column passes of 128 over k1p = H1 rounded up to 128 (its h1 columns
// past H1 are +0), layer 2 in column passes of 128 over n2p = H2 rounded up
// to 128, each over k2 = H1 rounded up to 64 rows of W2 (a ring slot's 64
// rows: four k16 steps), the head's units n2 = H2 rounded up to 32; the
// bf16 row strides s1 = k1p + 8 (h1) and kColStride (ring slots and the
// pass's h2): an odd number of 16-byte groups, so that the 8 rows of an
// ldmatrix fall on distinct banks.
constexpr int kBfTile = 64, kBfCols = 128, kBfRows = 64, kBfSlots = 4;
constexpr int kColStride = kBfCols + 8;
constexpr int kXP = 16 + 8;  // bf16 state rows: D padded to 16, then 8

struct Bf16Plan {
  int h1, h2, k1p, k2, n2p, n2, s1;
};

__host__ __device__ inline Bf16Plan bf16_plan(int h1, int h2) {
  const int k1p = round_up(h1, kBfCols);
  return {h1, h2, k1p, round_up(h1, kBfRows), round_up(h2, kBfCols), round_up(h2, 32), k1p + 8};
}

// The bf16 instance's packed weights (ppo_wide_pack's role for K3 wide), in
// one scratch buffer the wrapper allocates, made by the pack kernel before
// each launch of the body, each array 16-byte aligned, zero past the widths:
// w1t (k1p, 16) bf16, each unit's 16 (D padded) weights; w2 (k2, n2p) bf16;
// w2t (n2p, k2) bf16, W2 transposed, each unit's column contiguous (the
// recompute in the twin's order); w3 (OUT, n2p) float32 holding bf16
// values; b1 (k1p) and b2 (n2p) float32.  Byte offsets.
struct Bf16Pack {
  long long w1t, w2, w2t, w3, b1, b2, bytes;
};

__host__ __device__ inline long long aligned16(long long n) { return (n + 15) / 16 * 16; }

__host__ __device__ inline Bf16Pack bf16_pack(const Bf16Plan& p, int out) {
  Bf16Pack k{};
  long long at = 0;
  k.w1t = at, at += aligned16(2LL * p.k1p * 16);
  k.w2 = at, at += aligned16(2LL * p.k2 * p.n2p);
  k.w2t = at, at += aligned16(2LL * p.n2p * p.k2);
  k.w3 = at, at += aligned16(4LL * out * p.n2p);
  k.b1 = at, at += aligned16(4LL * p.k1p);
  k.b2 = at, at += aligned16(4LL * p.n2p);
  k.bytes = at;
  return k;
}

// The bf16 instance's dynamic shared memory, byte offsets: h1 (64, s1)
// bf16; the W2 ring (kBfSlots, 64, kColStride) bf16; the pass's h2 (64,
// kColStride) bf16; the states (64, kXP) bf16; two head buffers (OUT, 64)
// float32; each MLP warp's 32 words (fix_edges).
struct Bf16Smem {
  int h1, ring, h2, x, outs, fix, bytes;
};

__host__ __device__ inline Bf16Smem bf16_smem(const Bf16Plan& p, int out) {
  Bf16Smem m{};
  int at = 0;
  m.h1 = at, at += static_cast<int>(aligned16(2 * kBfTile * p.s1));
  m.ring = at, at += kBfSlots * kBfRows * kColStride * 2;
  m.h2 = at, at += kBfTile * kColStride * 2;
  m.x = at, at += static_cast<int>(aligned16(kBfTile * kXP * 2));
  m.outs = at, at += 2 * out * kBfTile * 4;
  m.fix = at, at += 8 * 32 * 4;
  m.bytes = at;
  return m;
}

// The bf16 instance's layer-2 recompute window over the narrow instance's
// (2^-19 + 2^-18 |v|) for a chain of h1 products: 1 up to 256, then h1 /
// 256 (the tensor cores' sum drifts further from a longer FMA chain).
__host__ __device__ inline float l2_tie_scale(int h1) {
  return h1 <= 256 ? 1.0f : static_cast<float>(h1) / 256.0f;
}

// Launches the wide bf16 instance of kind `env_kind` and `mode`, or with
// `probe` (modes sac and td3) its probe, on `st`: one persistent CTA an SM,
// reading the weights from `scratch` as launch_bf16_pack left them.
// Returns a CUDA error code.  Defined in offpolicy_collect_wide_bf16.cu.
cudaError_t launch_bf16(int env_kind, int mode, const float* params_host, const float* s_in,
                        int64_t batch, int hidden1, int hidden2, const Actor& w,
                        const float* consts, uint32_t seed, float* s_out, float* block,
                        const void* scratch, unsigned* probe, cudaStream_t st, int* ctas,
                        long long* smem);

// Launches the bf16 instance's pack kernel on `st`: the actor of `d` inputs
// and `out` head columns into `scratch` (bf16_pack(...).bytes), the layouts
// that launch_bf16 reads.  Returns a CUDA error code.  Defined in
// offpolicy_collect_wide_bf16.cu.
cudaError_t launch_bf16_pack(int d, int out, int hidden1, int hidden2, const Actor& w,
                             void* scratch, cudaStream_t st);

// 4. The action, env step, block and reset of env g (env-warp thread te
// of the tile): a copy of the narrow kernels' phase 4 with the tile's head
// outputs `outs` (column, env) at column stride `stride`; `s` the env's
// state.
template <class Env, int kMode>
__device__ __forceinline__ void env_step(float (&s)[Env::kD], const float* __restrict__ outs,
                                         int stride, int te, int64_t g, int64_t batch,
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
      const float o = outs[a * stride + te];
      if (kIsSac) {
        float uu = o;
        if (kMode == kSac) {
          const float ls = fminf(fmaxf(outs[(kA + a) * stride + te], -20.0f), 2.0f);
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

// Named barriers (0 is __syncthreads), as the narrow kernels': the MLP
// warps among themselves, and READY / FREE for each of the two tile buffers.
constexpr int kBarMlp = 1, kBarReady = 2, kBarFree = 4;
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

}  // namespace offpolicy_wide
}  // namespace reinmav
