// K7: the fused off-policy collection step of SAC, TD3 and DDPG, written for
// NVIDIA Hopper (sm_90a).
//
// Replaces reinmav_tpu/ops/pallas_offpolicy.py::collect_step_pallas (:155,
// pallas_call :206), the grid step _kernel (:71-148), for every kind of
// env_kinds.cuh: quadrotor3d-v0, MujocoQuadForce-v1, quadrotor2d-v0 and the
// two slung-load envs (the JAX K7's kinds whose state is the observation,
// pallas_offpolicy.py:237-241).  Per env column: the actor MLP
// (ReLU hiddens, linear head: sac._mlp_t), the action (SAC: log_std clipped
// to [-20, 2], tanh(mean + exp(log_std) * eps); TD3: clip(tanh(out) + noise *
// eps, -1, 1); the _det modes take eps = 0 / noise = 0), the warmup gate that
// picks a U(-1, 1) draw instead, the per-dim affine into the env's physical
// action box, the env step with the live params, the replay block in ring
// row order (obs, policy-space action, raw reward, the TERMINAL next_obs,
// done), and the reset of the done envs after the block is written.  The
// kernel is a template on the env structs of env_kinds.cuh and on the mode.
// Its plain PyTorch twin, with the same arithmetic and the same Philox
// draws, is reinmav_tpu_torch/ops/offpolicy.py::collect_step_reference.
//
// consts (device, float32): [warm_gate, explore_noise, lo(A), hi(A)]
// (sac._collect_consts).  Draws: Philox4x32-10 with key (seed, 0) and
// counter (env, 0, draw, stream): stream 3 the action noise (two draws,
// Box-Muller cosine branch as K2), stream 4 the warmup uniforms (one draw),
// stream 5 the U(-1, 1)^D resets (ceil(D / 4) draws); the hover reset draws
// nothing.  Action a takes word a of each draw, so an A = 2 kind uses the
// first two words of the same draws.  K2 uses streams 1 and 2.
//
// What bounds it on the card: arithmetic.  Per env the MLP is 2 (D H1 + H1
// H2 + H2 OUT) FP32 operations (OUT = 2A for SAC, A for TD3): about 142k at
// D = 13, H1 = H2 = 256, against about 232 B of states and block.  The H1 x
// H2 layer is nine tenths of it.
//
// The design (in brackets, the earlier design: one CTA a tile).  A 256 x
// 256 W2 (256 KB) does not fit the 227 KB of shared memory a CTA may have,
// so W2 streams and h1 stays: a persistent CTA of 384 threads, one an SM, walks tiles of 128
// envs (tiles blockIdx.x, + gridDim.x, ...).  Its 8 MLP warps run phases
// 1-3 of a tile while its 4 env warps run phase 4 of the tile before, the
// tile's states and head outputs double-buffered between them (named
// barriers: READY from the MLP warps to the env warps, FREE back) [one CTA
// of 256 threads a tile, 128 of them idle in phase 4 and 128 in phases
// 1-3 ... no overlap].  Shared memory at H1 = H2 = 256: 212 KB at D = 13,
// 218 KB at D = 16 (two state buffers, h1, a three-slot W2 ring, W1, W3,
// the biases, the chunk sums, two head buffers) [198 / 203 KB]; ptxas
// keeps it at 168 registers a thread, no spill [92-128].
//   0. Once a CTA: W1, W3 and the biases, zero past the widths.
//   1. The ring's first two W2 tiles are asked for (cp.async), then the
//      tile's states are loaded, zero past the batch.
//   2. h1 = relu(W1^T x + b1), each thread an 8-unit x 8-env register tile
//      over d [one output at a time, two shared loads an FMA].
//   3. h2 = relu(W2^T h1 + b2) in passes of 128 units, each thread an
//      8-unit x 8-env register tile (64 FFMA to 4 LDS.128 a j) over j in
//      order [4 x 4 tiles over 32-unit chunks, 16 FFMA to 2 LDS.128].  W2
//      streams through the ring in tiles of 16 rows x 128 columns: tile s
//      + 2 is copied by cp.async (4 B a copy, zero past the widths) while
//      tile s is multiplied, one barrier a tile [each 32-column chunk
//      copied through registers, 4 loads in flight, between two barriers,
//      nothing in flight while it multiplied].  A thread's units are two
//      4-unit groups g and g + 4 of one 32-unit chunk (the ring, W3 and b2
//      hold each pass's units permuted so that each group is one aligned
//      float4), so that the head folds each chunk in the earlier order: each
//      group's units into the head in unit order, groups g and g + 4 added
//      in the thread, then the xor-shuffle sums 2 and 1 across the chunk's
//      four lanes [xor 4, 2, 1 across eight lanes: the same additions]; the
//      chunks' sums go through shared memory and are added in chunk order,
//      then b3.
//   4. One env-warp thread per env: sampling, the env step, the block and
//      the reset, as in the earlier design.
// Every (unit, env) sum keeps the earlier order (phase 2's d, phase 3's
// j, the fold's units, groups and chunks), so at the widths the earlier
// design took (two equal layers, a multiple of 32) the block and new states
// are its bit for bit; zero-filled units past a width add +0 to a sum that
// is never -0.  No atomics: a rerun is bitwise equal.  FP32 FMAs only:
// TF32 or 3xTF32 products on the tensor cores would round otherwise.  An
// earlier note here held that TMA would change the numerics: a copy
// changes no value; cp.async serves here as the Tensor Memory Accelerator
// would, 4 B a copy so that any width streams.
// Widths: H1 and H2 each from 1 to 256 (runtime arguments); an actor with a
// layer past 256 (to 1024) runs K7's wide instances, offpolicy_collect_wide.cu.
//
// compute_dtype "bfloat16" (the TPU kernel's _mm with cd bf16,
// pallas_offpolicy.py:97-101, :186) launches offpolicy_collect_bf16_kernel,
// a body of its own with the products on the tensor cores and W2 whole in
// shared memory (offpolicy_collect_bf16.cuh, built in
// offpolicy_collect_bf16.cu).  Its env warps keep a copy of phase 4
// below (env_step): with phase 4 in a header both kernels include, nvcc
// allocated and ordered every float32 instance otherwise (PERF.md §6).

#include <cuda_runtime.h>
#include <stdint.h>

#include "env_kinds.cuh"
#include "offpolicy_collect_bf16.cuh"

namespace {

constexpr int kMlp = 256;         // threads of the MLP warps (8)
constexpr int kEnvThreads = 128;  // threads of the env warps (4), one an env
constexpr int kThreads = kMlp + kEnvThreads;
constexpr int kTile = 128;    // envs per tile
constexpr int kPass = 128;    // layer-2 units per pass
constexpr int kRows = 16;     // W2 rows per ring tile
constexpr int kSlots = 3;     // ring tiles
constexpr int kChunk = 32;    // units per chunk of the head's fold
constexpr int kMaxHidden = 256;
constexpr uint32_t kEpsStream = 3u, kWarmStream = 4u, kResetStream = 5u;

enum Mode { kSac = 0, kSacDet = 1, kTd3 = 2, kTd3Det = 3 };

struct Actor {
  const float* w1;  // (D, H1)
  const float* b1;  // (H1,)
  const float* w2;  // (H1, H2)
  const float* b2;  // (H2,)
  const float* w3;  // (H2, OUT)
  const float* b3;  // (OUT,)
};

// The widths a launch works at: the layers rounded up to whole passes
// (h1p, h2p: 128 or 256) and the j extent of layer 2 (k1: H1 rounded up to
// a ring tile).
struct Widths {
  int h1, h2, h1p, h2p, k1, chunks;
};

inline Widths widths(int h1, int h2) {
  const int h1p = (h1 + kPass - 1) / kPass * kPass;
  const int h2p = (h2 + kPass - 1) / kPass * kPass;
  return {h1, h2, h1p, h2p, (h1 + kRows - 1) / kRows * kRows, (h2 + kChunk - 1) / kChunk};
}

// Dynamic shared memory, in floats: x (2, D, kTile), h1 (h1p, kTile), the
// ring (kSlots, kRows, kPass), w1 (D, h1p), w3 (OUT, h2p), b1 (h1p), b2
// (h2p), b3 (8), the chunk sums (4, OUT, kTile), out (2, OUT, kTile).  Every
// array starts 16-byte aligned.
inline size_t smem_floats(int d, const Widths& w, int out) {
  return 2 * static_cast<size_t>(d) * kTile + static_cast<size_t>(w.h1p) * kTile +
         kSlots * kRows * kPass + static_cast<size_t>(d) * w.h1p +
         static_cast<size_t>(w.h2p) * out + w.h1p + w.h2p + 8 + 4 * out * kTile +
         2 * static_cast<size_t>(out) * kTile;
}

// Named barriers (0 is __syncthreads): the MLP warps among themselves, and
// for each of the two tile buffers (states and head outputs) READY (the MLP
// warps arrive, the env warps wait) and FREE (the other way round).
constexpr int kBarMlp = 1, kBarReady = 2, kBarFree = 4;
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// A 4-byte asynchronous copy to shared memory; src_bytes 0 writes zero.
__device__ __forceinline__ void copy4(float* dst, const float* src, int src_bytes) {
  const unsigned int d = static_cast<unsigned int>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void copy_wait_all_but_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Where column u (0-127) of a pass lands in the ring's rows, in W3 and in
// b2: column 32 c + 16 h + 4 g + k (chunk c, half h, group g) at 64 h + 16
// c + 4 g + k, so that a thread's two groups are the float4s at 4 (4 c + g)
// and 64 + that.
__device__ __forceinline__ int pass_pos(int u) {
  return 64 * ((u >> 4) & 1) + 16 * (u >> 5) + (u & 15);
}

// The W2 tile of rows j0 .. j0 + kRows - 1 and columns u0 .. u0 + kPass - 1
// into `slot` (rows of kPass, each permuted by pass_pos), zero past the
// widths.  Thread tid copies column tid % kPass of rows tid / kPass + 2 n.
__device__ __forceinline__ void copy_tile(float* slot, const float* __restrict__ w2, int j0,
                                          int u0, const Widths& wd, int tid) {
  const int u = tid % kPass, r0 = tid / kPass;
  float* dst = slot + r0 * kPass + pass_pos(u);
  const bool col = u0 + u < wd.h2;
  const float* src = w2 + static_cast<int64_t>(j0 + r0) * wd.h2 + u0 + u;
#pragma unroll
  for (int n = 0; n < kRows * kPass / kMlp; ++n) {
    const int r = r0 + n * (kMlp / kPass);
    const bool ok = col && j0 + r < wd.h1;
    copy4(dst + n * (kMlp / kPass) * kPass,
          ok ? src + static_cast<int64_t>(n) * (kMlp / kPass) * wd.h2 : w2, ok ? 4 : 0);
  }
}

// 4. One env of a tile (thread tid of the env warps, env g of the batch):
// the action, the env step, the block, the reset.  `x` the tile's states,
// `outs` its head outputs.
template <class Env, int kMode, bool kCount>
__device__ __forceinline__ void env_step(const float* __restrict__ x,
                                         const float* __restrict__ outs, int tid, int64_t g,
                                         int64_t batch, const float* __restrict__ consts,
                                         uint32_t seed, const typename Env::Params& p,
                                         float* __restrict__ s_out, float* __restrict__ block,
                                         int* __restrict__ counts) {
  constexpr int kD = Env::kD, kA = Env::kA;
  constexpr bool kIsSac = kMode == kSac || kMode == kSacDet;
  const uint32_t env = static_cast<uint32_t>(g);
  float s[kD];
#pragma unroll
  for (int d = 0; d < kD; ++d) s[d] = x[d * kTile + tid];

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
      const float o = outs[a * kTile + tid];
      if (kIsSac) {
        float uu = o;
        if (kMode == kSac) {
          const float ls = fminf(fmaxf(outs[(kA + a) * kTile + tid], -20.0f), 2.0f);
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
  if constexpr (kCount) counts[g] += Env::taut(s, p) ? 1 : 0;
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

// Phases 1-3 of one tile for the MLP warps (tid < kMlp): its states into
// `x` (zero past the batch), h1, h2 through the W2 ring and the fold into
// the head outputs `outs`.  Local iteration n of the CTA, buffer `buf`.
template <class Env, int kMode>
__device__ __forceinline__ void mlp_tile(const float* __restrict__ s_in, int64_t batch,
                                         int64_t e0, int n, int buf, const Widths& wd,
                                         const Actor& w, float* __restrict__ x,
                                         float* __restrict__ h1, float* __restrict__ ring,
                                         const float* __restrict__ w1s,
                                         const float* __restrict__ w3s,
                                         const float* __restrict__ b1s,
                                         const float* __restrict__ b2s,
                                         const float* __restrict__ b3s, float* __restrict__ sums,
                                         float* __restrict__ outs, int tid) {
  constexpr int kD = Env::kD, kA = Env::kA;
  constexpr bool kIsSac = kMode == kSac || kMode == kSacDet;
  constexpr int kOut = kIsSac ? 2 * kA : kA;
  const int per_pass = wd.k1 / kRows;
  const int n_tiles = (wd.h2p / kPass) * per_pass;

  // 1. The ring's first two tiles in flight; the tile's states (zero past
  // the batch) into its buffer once the env warps are done with it.
  int next_j = 0, next_p = 0;  // the next tile to copy: its row tile and pass
#pragma unroll
  for (int t = 0; t < kSlots - 1; ++t) {
    if (t < n_tiles) {
      copy_tile(ring + t * kRows * kPass, w.w2, next_j * kRows, next_p * kPass, wd, tid);
      if (++next_j == per_pass) next_j = 0, ++next_p;
    }
    copy_commit();
  }
  if (n >= 2) bar_sync(kBarFree + buf, kThreads);  // the env warps are done with x, outs
  for (int i = tid; i < kD * kTile; i += kMlp) {
    const int d = i / kTile;
    const int64_t g = e0 + i % kTile;
    x[i] = g < batch ? s_in[d * batch + g] : 0.0f;
  }
  bar_sync(kBarMlp, kMlp);

  // 2. h1 = relu(W1^T x + b1): thread (unit group tid / 16, env group tid
  // % 16) takes units 8 (tid / 16) + i and envs 4 (tid % 16) + e, 64 + that.
  {
    const int ug = tid / 16, eg = tid % 16;
    for (int p1 = 0; p1 < wd.h1p; p1 += kPass) {
      const int u0 = p1 + 8 * ug;
      float acc[8][8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[i][e] = 0.0f;
#pragma unroll
      for (int d = 0; d < kD; ++d) {
        const float4 wa = *reinterpret_cast<const float4*>(&w1s[d * wd.h1p + u0]);
        const float4 wb = *reinterpret_cast<const float4*>(&w1s[d * wd.h1p + u0 + 4]);
        const float4 xa = *reinterpret_cast<const float4*>(&x[d * kTile + 4 * eg]);
        const float4 xb = *reinterpret_cast<const float4*>(&x[d * kTile + 64 + 4 * eg]);
        const float wv[8] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
        const float xv[8] = {xa.x, xa.y, xa.z, xa.w, xb.x, xb.y, xb.z, xb.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[i][e] += wv[i] * xv[e];
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float b = b1s[u0 + i];
        float4 lo, hi;
        lo.x = fmaxf(acc[i][0] + b, 0.0f);
        lo.y = fmaxf(acc[i][1] + b, 0.0f);
        lo.z = fmaxf(acc[i][2] + b, 0.0f);
        lo.w = fmaxf(acc[i][3] + b, 0.0f);
        hi.x = fmaxf(acc[i][4] + b, 0.0f);
        hi.y = fmaxf(acc[i][5] + b, 0.0f);
        hi.z = fmaxf(acc[i][6] + b, 0.0f);
        hi.w = fmaxf(acc[i][7] + b, 0.0f);
        *reinterpret_cast<float4*>(&h1[(u0 + i) * kTile + 4 * eg]) = lo;
        *reinterpret_cast<float4*>(&h1[(u0 + i) * kTile + 64 + 4 * eg]) = hi;
      }
    }
  }

  // 3. h2 = relu(W2^T h1 + b2) a pass of 128 units at a time, W2 through the
  // ring, folded into the head after each pass.  Thread (lane, warp): unit
  // group ug = lane % 16 (chunk ug / 4 of the pass, group g = ug % 4 and g +
  // 4 of it), envs 8 eg .. 8 eg + 7 with eg = lane / 16 + 2 warp.
  {
  const int lane = tid % 32;
  const int ug = lane % 16, g = ug % 4, cl = ug / 4;
  const int eg = lane / 16 + 2 * (tid / 32);
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
      copy_tile(ring + s2 * kRows * kPass, w.w2, next_j * kRows, next_p * kPass, wd, tid);
      if (++next_j == per_pass) next_j = 0, ++next_p;
    }
    copy_commit();
    const float* slot = ring + slot_i * kRows * kPass;
    const float* hrow = h1 + tile_j * kRows * kTile + 8 * eg;
    slot_i = slot_i == kSlots - 1 ? 0 : slot_i + 1;
#pragma unroll
    for (int jj = 0; jj < kRows; ++jj) {
      const float4 wa = *reinterpret_cast<const float4*>(&slot[jj * kPass + 4 * ug]);
      const float4 wb = *reinterpret_cast<const float4*>(&slot[jj * kPass + 64 + 4 * ug]);
      const float4 ha = *reinterpret_cast<const float4*>(&hrow[jj * kTile]);
      const float4 hb = *reinterpret_cast<const float4*>(&hrow[jj * kTile + 4]);
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
    // are u0 + k (group A) and u0 + 16 + k (group B) of the pass, u0 = 32 cl
    // + 4 g: the earlier design's lanes kq = g and g + 4 of chunk cl; their
    // W3 rows and b2 entries are the float4s at 4 ug and 64 + 4 ug
    // (pass_pos).
    const int base = pass * kPass + 4 * ug;
    {
      const float4 ba = *reinterpret_cast<const float4*>(&b2s[base]);
      const float4 bb = *reinterpret_cast<const float4*>(&b2s[base + 64]);
      const float b[8] = {ba.x, ba.y, ba.z, ba.w, bb.x, bb.y, bb.z, bb.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[i][e] = fmaxf(acc[i][e] + b[i], 0.0f);
    }
#pragma unroll
    for (int o = 0; o < kOut; ++o) {
      const float4 wa = *reinterpret_cast<const float4*>(&w3s[o * wd.h2p + base]);
      const float4 wb = *reinterpret_cast<const float4*>(&w3s[o * wd.h2p + base + 64]);
      const float w3a[4] = {wa.x, wa.y, wa.z, wa.w}, w3b[4] = {wb.x, wb.y, wb.z, wb.w};
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
        if (g == 0) sums[(cl * kOut + o) * kTile + 8 * eg + e] = v;
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[i][e] = 0.0f;
    bar_sync(kBarMlp, kMlp);
    // The head: the pass's chunks added in chunk order (from 0 in pass 0).
    for (int i = tid; i < kOut * kTile; i += kMlp) {
      float head = pass == 0 ? 0.0f : outs[i];
      const int o = i / kTile, e = i % kTile;
      for (int c = 0; c < kPass / kChunk && pass * (kPass / kChunk) + c < wd.chunks; ++c) {
        head += sums[(c * kOut + o) * kTile + e];
      }
      outs[i] = t == n_tiles - 1 ? head + b3s[o] : head;
    }
    ++pass;
  }
  }
}

// The kernel's body; kCount adds each env's taut tether (0 or 1) to
// counts[env] (the counting kernel, slung-load kinds only).  A persistent
// CTA walks the tiles blockIdx.x, + gridDim.x, ...: its 8 MLP warps run
// phases 1-3 of tile n while its 4 env warps run phase 4 of tile n - 1, the
// states and head outputs double-buffered between them.
template <class Env, int kMode, bool kCount>
__device__ __forceinline__ void collect_body(const float* __restrict__ s_in, int64_t batch,
                                             const Widths wd, const Actor& w,
                                             const float* __restrict__ consts, uint32_t seed,
                                             const typename Env::Params& p,
                                             float* __restrict__ s_out,
                                             float* __restrict__ block,
                                             int* __restrict__ counts) {
  constexpr int kD = Env::kD, kA = Env::kA;
  constexpr bool kIsSac = kMode == kSac || kMode == kSacDet;
  constexpr int kOut = kIsSac ? 2 * kA : kA;
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;  // 2 x (D, kTile)
  float* h1 = xs + 2 * kD * kTile;
  float* ring = h1 + wd.h1p * kTile;
  float* w1s = ring + kSlots * kRows * kPass;
  float* w3s = w1s + kD * wd.h1p;
  float* b1s = w3s + wd.h2p * kOut;
  float* b2s = b1s + wd.h1p;
  float* b3s = b2s + wd.h2p;
  float* sums = b3s + 8;
  float* outs = sums + 4 * kOut * kTile;  // 2 x (OUT, kTile)

  const int tid = threadIdx.x;
  const int64_t n_env_tiles = (batch + kTile - 1) / kTile;
  const int count = blockIdx.x < n_env_tiles
                        ? static_cast<int>((n_env_tiles - 1 - blockIdx.x) / gridDim.x) + 1
                        : 0;

  // The small weights, once a CTA, zero past the widths.
  for (int i = tid; i < kD * wd.h1p; i += kThreads) {
    const int d = i / wd.h1p, j = i % wd.h1p;
    w1s[i] = j < wd.h1 ? w.w1[d * wd.h1 + j] : 0.0f;
  }
  // W3 as (OUT, h2p) and b2, each pass's units in pass_pos order.
  for (int i = tid; i < wd.h2p * kOut; i += kThreads) {
    const int u = i / kOut, o = i % kOut;
    w3s[o * wd.h2p + u - u % kPass + pass_pos(u % kPass)] = u < wd.h2 ? w.w3[i] : 0.0f;
  }
  for (int i = tid; i < wd.h1p; i += kThreads) b1s[i] = i < wd.h1 ? w.b1[i] : 0.0f;
  for (int i = tid; i < wd.h2p; i += kThreads) {
    b2s[i - i % kPass + pass_pos(i % kPass)] = i < wd.h2 ? w.b2[i] : 0.0f;
  }
  if (tid < kOut) b3s[tid] = w.b3[tid];
  __syncthreads();

  if (tid < kMlp) {
    for (int n = 0; n < count; ++n) {
      const int buf = n & 1;
      const int64_t e0 = (blockIdx.x + static_cast<int64_t>(n) * gridDim.x) * kTile;
      mlp_tile<Env, kMode>(s_in, batch, e0, n, buf, wd, w, xs + buf * kD * kTile, h1, ring, w1s,
                           w3s, b1s, b2s, b3s, sums, outs + buf * kOut * kTile, tid);
      bar_arrive(kBarReady + buf, kThreads);  // x and outs of tile n are ready
    }
  } else {
    const int te = tid - kMlp;
    for (int n = 0; n < count; ++n) {
      const int buf = n & 1;
      const int64_t g = (blockIdx.x + static_cast<int64_t>(n) * gridDim.x) * kTile + te;
      bar_sync(kBarReady + buf, kThreads);
      if (g < batch) {
        env_step<Env, kMode, kCount>(xs + buf * kD * kTile, outs + buf * kOut * kTile, te, g,
                                     batch, consts, seed, p, s_out, block, counts);
      }
      if (n + 2 < count) bar_arrive(kBarFree + buf, kThreads);  // the MLP warps may refill
    }
  }
}

template <class Env, int kMode>
__global__ void __launch_bounds__(kThreads, 1)
offpolicy_collect_kernel(const float* __restrict__ s_in, int64_t batch, Widths wd, Actor w,
                         const float* __restrict__ consts, uint32_t seed,
                         typename Env::Params p, float* __restrict__ s_out,
                         float* __restrict__ block) {
  collect_body<Env, kMode, false>(s_in, batch, wd, w, consts, seed, p, s_out, block, nullptr);
}

// The counting kernel (not on any training path): K7 with counts[env] += the
// tether was taut at the start of the step.
template <class Env, int kMode>
__global__ void __launch_bounds__(kThreads, 1)
offpolicy_collect_count_kernel(const float* __restrict__ s_in, int64_t batch, Widths wd,
                               Actor w, const float* __restrict__ consts, uint32_t seed,
                               typename Env::Params p, float* __restrict__ s_out,
                               float* __restrict__ block, int* __restrict__ counts) {
  collect_body<Env, kMode, true>(s_in, batch, wd, w, consts, seed, p, s_out, block, counts);
}

// What a float32 launch of kind Env, mode kMode and widths wd does: allows
// its shared memory and, with a stream, launches (counts: the counting
// kernel, the slung-load kinds only); else, with `ctas`, stores its
// resident CTAs an SM and `smem` its dynamic shared memory.
template <class Env, int kMode>
cudaError_t launch_mode(const float* s_in, int64_t batch, const Widths& wd, const Actor& w,
                        const float* consts, uint32_t seed, const float* params_host,
                        float* s_out, float* block, int* counts, cudaStream_t st, int* ctas,
                        long long* smem) {
  constexpr int kOut = (kMode == kSac || kMode == kSacDet) ? 2 * Env::kA : Env::kA;
  const size_t bytes = smem_floats(Env::kD, wd, kOut) * sizeof(float);
  // Persistent CTAs, one an SM (or one a tile where there are fewer).
  int device = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return e;
  const int64_t tiles = (batch + kTile - 1) / kTile;
  const auto blocks = static_cast<unsigned int>(tiles < sms ? tiles : sms);
  if (counts != nullptr) {
    if constexpr (Env::kTether) {
      auto kernel = offpolicy_collect_count_kernel<Env, kMode>;
      cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
      if (err != cudaSuccess) return err;
      kernel<<<blocks, kThreads, bytes, st>>>(s_in, batch, wd, w, consts, seed,
                                              Env::params(params_host), s_out, block, counts);
      return cudaGetLastError();
    } else {
      return cudaErrorInvalidValue;
    }
  }
  auto kernel = offpolicy_collect_kernel<Env, kMode>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  if (ctas != nullptr) {
    *smem = static_cast<long long>(bytes);
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas, kernel, kThreads, bytes);
  }
  kernel<<<blocks, kThreads, bytes, st>>>(s_in, batch, wd, w, consts, seed,
                                          Env::params(params_host), s_out, block);
  return cudaGetLastError();
}

template <class Env>
cudaError_t launch_env(int mode, const float* s_in, int64_t batch, const Widths& wd,
                       const Actor& w, const float* consts, uint32_t seed,
                       const float* params_host, float* s_out, float* block, int* counts,
                       cudaStream_t st, int* ctas, long long* smem) {
  switch (mode) {
    case kSac:
      return launch_mode<Env, kSac>(s_in, batch, wd, w, consts, seed, params_host, s_out, block,
                                    counts, st, ctas, smem);
    case kSacDet:
      return launch_mode<Env, kSacDet>(s_in, batch, wd, w, consts, seed, params_host, s_out,
                                       block, counts, st, ctas, smem);
    case kTd3:
      return launch_mode<Env, kTd3>(s_in, batch, wd, w, consts, seed, params_host, s_out, block,
                                    counts, st, ctas, smem);
    case kTd3Det:
      return launch_mode<Env, kTd3Det>(s_in, batch, wd, w, consts, seed, params_host, s_out,
                                       block, counts, st, ctas, smem);
    default:
      return cudaErrorInvalidValue;
  }
}

bool widths_ok(int hidden1, int hidden2) {
  return hidden1 >= 1 && hidden1 <= kMaxHidden && hidden2 >= 1 && hidden2 <= kMaxHidden;
}

// Both launch entry points below.
int launch(int env_kind, int mode, int bf16, const void* params_host, int n_params,
           const void* states_in, long long batch, int hidden1, int hidden2, const void* w1,
           const void* b1, const void* w2, const void* b2, const void* w3, const void* b3,
           const void* consts, unsigned int seed, void* states_out, void* block, void* counts,
           void* probe, void* stream) {
  if (batch <= 0 || !widths_ok(hidden1, hidden2)) return static_cast<int>(cudaErrorInvalidValue);
  const auto* s_in = static_cast<const float*>(states_in);
  const auto* c = static_cast<const float*>(consts);
  const auto* h = static_cast<const float*>(params_host);
  auto* s_out = static_cast<float*>(states_out);
  auto* blk = static_cast<float*>(block);
  const auto st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = reinmav::with_env_kind(env_kind, [&](auto env) {
    using Env = decltype(env);
    if (n_params != Env::kParams) return cudaErrorInvalidValue;
    if (bf16) {
      if (counts != nullptr) return cudaErrorInvalidValue;
      const reinmav::offpolicy_bf16::Actor w{
          static_cast<const float*>(w1), static_cast<const float*>(b1),
          static_cast<const float*>(w2), static_cast<const float*>(b2),
          static_cast<const float*>(w3), static_cast<const float*>(b3)};
      return reinmav::offpolicy_bf16::launch(Env::kKind, mode, h, s_in, batch, hidden1, hidden2,
                                             w, c, seed, s_out, blk,
                                             static_cast<unsigned*>(probe), st);
    }
    const Actor w{static_cast<const float*>(w1), static_cast<const float*>(b1),
                  static_cast<const float*>(w2), static_cast<const float*>(b2),
                  static_cast<const float*>(w3), static_cast<const float*>(b3)};
    return launch_env<Env>(mode, s_in, batch, widths(hidden1, hidden2), w, c, seed, h, s_out,
                           blk, static_cast<int*>(counts), st, nullptr, nullptr);
  });
  return static_cast<int>(err);
}

}  // namespace

// C interface, bound with ctypes (reinmav_tpu_torch/_build.py).  Launches on
// the given stream, does not synchronise, and returns a CUDA error code.
// env_kind: a kind id of env_kinds.cuh (0 quadrotor3d-v0, 1
// MujocoQuadForce-v1, 2 quadrotor2d-v0, 3 quadrotor2d-slungload-v0, 4
// quadrotor3d-slungload-v0), params_host the floats of its params vector,
// states (D, B).  mode: 0 sac, 1 sac_det, 2 td3, 3 td3_det (the head w3 is
// (H2, 2A) for sac, (H2, A) for td3).  hidden1, hidden2: the widths H1, H2
// of the two hidden layers, each from 1 to 256 (w1 (D, H1), w2 (H1, H2)).
// Any other kind, mode, width or number of params is refused with
// cudaErrorInvalidValue and nothing runs.  Outputs: states_out (D, B) and
// block (2D + A + 2, B), float32.  counts: null (every training path), or B
// int32 to which each env's taut tether at the start of the step (0 or 1)
// is added (the slung-load kinds; refused for another kind).  bf16 nonzero:
// the bf16 instance, which rounds the weights itself (no counts).
extern "C" int offpolicy_collect_launch(int env_kind, int mode, int bf16, const void* params_host,
                                        int n_params, const void* states_in, long long batch,
                                        int hidden1, int hidden2, const void* w1,
                                        const void* b1, const void* w2, const void* b2,
                                        const void* w3, const void* b3, const void* consts,
                                        unsigned int seed, void* states_out, void* block,
                                        void* counts, void* stream) {
  return launch(env_kind, mode, bf16, params_host, n_params, states_in, batch, hidden1, hidden2,
                w1, b1, w2, b2, w3, b3, consts, seed, states_out, block, counts, nullptr, stream);
}

// The bf16 instance's probe (offpolicy_collect_bf16.cuh; no training path
// launches it): offpolicy_collect_launch's arguments in mode 0 (sac) or 2
// (td3), bf16, no counts, and `probe`, 6 uint32 on the device, zeroed by
// the caller, to which the launch adds the units of L1 and L2 recomputed
// in the twin's order and their misses, and takes the largest |sum -
// twin's| / tie(twin's) of each layer (float bits).  Its outputs are the
// bf16 instance's.
extern "C" int offpolicy_collect_bf16_probe_launch(int env_kind, int mode,
                                                   const void* params_host, int n_params,
                                                   const void* states_in, long long batch,
                                                   int hidden1, int hidden2, const void* w1,
                                                   const void* b1, const void* w2, const void* b2,
                                                   const void* w3, const void* b3,
                                                   const void* consts, unsigned int seed,
                                                   void* states_out, void* block, void* probe,
                                                   void* stream) {
  if (probe == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return launch(env_kind, mode, 1, params_host, n_params, states_in, batch, hidden1, hidden2, w1,
                b1, w2, b2, w3, b3, consts, seed, states_out, block, nullptr, probe, stream);
}

// The main path's kernel for this kind, mode and widths: its resident CTAs
// an SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor, after its shared
// memory is allowed) into *ctas and its dynamic shared memory in bytes into
// *smem_bytes.  Returns a CUDA error code; refuses what the launch refuses.
extern "C" int offpolicy_collect_occupancy(int env_kind, int mode, int hidden1, int hidden2,
                                           int* ctas, long long* smem_bytes) {
  if (!widths_ok(hidden1, hidden2)) return static_cast<int>(cudaErrorInvalidValue);
  const Widths wd = widths(hidden1, hidden2);
  const cudaError_t err = reinmav::with_env_kind(env_kind, [&](auto env) {
    return launch_env<decltype(env)>(mode, nullptr, 1, wd, Actor{}, nullptr, 0u, nullptr, nullptr,
                                     nullptr, nullptr, nullptr, ctas, smem_bytes);
  });
  return static_cast<int>(err);
}
