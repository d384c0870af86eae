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
// What bounds it on the card: arithmetic.  Per env the MLP is 2 (D H + H H +
// H OUT) FP32 operations (OUT = 2A for SAC, A for TD3): about 142k at D = 13,
// H = 256, against about 232 B of states and block.  The H x H layer is nine
// tenths of it.
//
// What the design does about it: K2's one env per thread cannot hold 256
// activations, and a 256 x 256 W2 (256 KB) does not fit the 227 KB of
// shared memory.  So one 256-thread CTA takes a tile of 128 envs:
//   1. the tile's states, W1, W3 and the biases go to shared memory;
//   2. h1 = relu(W1^T x + b1) for the tile, (H, 128) in shared memory, each
//      thread producing hidden units over the tile;
//   3. W2's columns in chunks of 32: each chunk is copied to shared memory
//      (coalesced rows through L2), each thread computes a 4 x 4 register
//      tile (4 units x 4 envs) of h2 = relu(W2^T h1 + b2), and folds it into
//      the head at once: W3's rows of those 4 units times h2, summed over
//      the 8 threads of the chunk by warp shuffles into head accumulators
//      held in registers.  The whole h2 is never stored;
//   4. one thread per env (128 of the 256): sampling, the env step, the
//      block and the reset.
// No atomics: every sum has a fixed order, so a rerun is bitwise equal.
// Widths H: any multiple of 32 up to 256 (a runtime argument); shared
// memory is 198 KB at H = 256 and D = 13, 203 KB at D = 16 (one CTA per SM).  Tensor cores (TF32,
// wgmma) and TMA would change the numerics and are not used.

#include <cuda_runtime.h>
#include <stdint.h>

#include "env_kinds.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 128;    // envs per CTA
constexpr int kChunk = 32;    // W2 columns per pass
constexpr int kMaxHidden = 256;
constexpr uint32_t kEpsStream = 3u, kWarmStream = 4u, kResetStream = 5u;

enum Mode { kSac = 0, kSacDet = 1, kTd3 = 2, kTd3Det = 3 };

struct Actor {
  const float* w1;  // (D, H)
  const float* b1;  // (H,)
  const float* w2;  // (H, H)
  const float* b2;  // (H,)
  const float* w3;  // (H, OUT)
  const float* b3;  // (OUT,)
};

// Dynamic shared memory, in floats: x (D, kTile), h1 (H, kTile), w2c (H,
// kChunk), w1 (D, H), w3 (H, OUT), b1 (H), b2 (H), b3 (8), out (OUT, kTile).
// Every array starts 16-byte aligned (kTile and H are multiples of 4).
inline size_t smem_bytes(int d, int h, int out) {
  const size_t floats = static_cast<size_t>(d) * kTile + static_cast<size_t>(h) * kTile +
                        static_cast<size_t>(h) * kChunk + static_cast<size_t>(d) * h +
                        static_cast<size_t>(h) * out + 2 * h + 8 +
                        static_cast<size_t>(out) * kTile;
  return floats * sizeof(float);
}

// The kernel's body; kCount adds each env's taut tether (0 or 1) to
// counts[env] (the counting kernel, slung-load kinds only).
template <class Env, int kMode, bool kCount>
__device__ __forceinline__ void collect_body(const float* __restrict__ s_in, int64_t batch,
                                             int hidden, const Actor& w,
                                             const float* __restrict__ consts, uint32_t seed,
                                             const typename Env::Params& p,
                                             float* __restrict__ s_out,
                                             float* __restrict__ block,
                                             int* __restrict__ counts) {
  constexpr int kD = Env::kD, kA = Env::kA;
  constexpr bool kIsSac = kMode == kSac || kMode == kSacDet;
  constexpr int kOut = kIsSac ? 2 * kA : kA;
  extern __shared__ __align__(16) float smem[];
  const int H = hidden;
  float* x = smem;
  float* h1 = x + kD * kTile;
  float* w2c = h1 + H * kTile;
  float* w1s = w2c + H * kChunk;
  float* w3s = w1s + kD * H;
  float* b1s = w3s + H * kOut;
  float* b2s = b1s + H;
  float* b3s = b2s + H;
  float* outs = b3s + 8;

  const int tid = threadIdx.x;
  const int64_t e0 = static_cast<int64_t>(blockIdx.x) * kTile;

  // 1. The tile's states (zero past the batch), the small weights.
  for (int i = tid; i < kD * kTile; i += kThreads) {
    const int d = i / kTile;
    const int64_t g = e0 + i % kTile;
    x[i] = g < batch ? s_in[d * batch + g] : 0.0f;
  }
  for (int i = tid; i < kD * H; i += kThreads) w1s[i] = w.w1[i];
  for (int i = tid; i < H * kOut; i += kThreads) w3s[i] = w.w3[i];
  for (int i = tid; i < H; i += kThreads) {
    b1s[i] = w.b1[i];
    b2s[i] = w.b2[i];
  }
  if (tid < kOut) b3s[tid] = w.b3[tid];
  __syncthreads();

  // 2. h1 = relu(W1^T x + b1): unit j over the tile's envs (a warp shares j).
  for (int i = tid; i < H * kTile; i += kThreads) {
    const int j = i / kTile, e = i % kTile;
    float z = 0.0f;
#pragma unroll
    for (int d = 0; d < kD; ++d) z += w1s[d * H + j] * x[d * kTile + e];
    h1[i] = fmaxf(z + b1s[j], 0.0f);
  }

  // 3. h2 in chunks of 32 units, folded into the head as it is made.
  const int kq = tid % 8;  // units 4 kq .. 4 kq + 3 of the chunk
  const int eq = tid / 8;  // envs 4 eq .. 4 eq + 3 of the tile
  float head[kOut][4];
#pragma unroll
  for (int o = 0; o < kOut; ++o)
#pragma unroll
    for (int e = 0; e < 4; ++e) head[o][e] = 0.0f;

  for (int c = 0; c < H / kChunk; ++c) {
    __syncthreads();  // h1 is complete; the previous chunk's w2c is consumed
    for (int i = tid; i < H * kChunk; i += kThreads) {
      const int j = i / kChunk, kk = i % kChunk;
      w2c[i] = w.w2[static_cast<int64_t>(j) * H + c * kChunk + kk];
    }
    __syncthreads();
    float acc[4][4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[k][e] = 0.0f;
#pragma unroll 4
    for (int j = 0; j < H; ++j) {
      const float4 wv = *reinterpret_cast<const float4*>(&w2c[j * kChunk + 4 * kq]);
      const float4 hv = *reinterpret_cast<const float4*>(&h1[j * kTile + 4 * eq]);
      const float wk[4] = {wv.x, wv.y, wv.z, wv.w};
      const float he[4] = {hv.x, hv.y, hv.z, hv.w};
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[k][e] += wk[k] * he[e];
    }
    float part[kOut][4];
#pragma unroll
    for (int o = 0; o < kOut; ++o)
#pragma unroll
      for (int e = 0; e < 4; ++e) part[o][e] = 0.0f;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int unit = c * kChunk + 4 * kq + k;
      const float b = b2s[unit];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float h2 = fmaxf(acc[k][e] + b, 0.0f);
#pragma unroll
        for (int o = 0; o < kOut; ++o) part[o][e] += w3s[unit * kOut + o] * h2;
      }
    }
    // Sum over the 8 threads of the chunk (lanes that share eq).
#pragma unroll
    for (int o = 0; o < kOut; ++o)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float v = part[o][e];
        v += __shfl_xor_sync(0xFFFFFFFFu, v, 4);
        v += __shfl_xor_sync(0xFFFFFFFFu, v, 2);
        v += __shfl_xor_sync(0xFFFFFFFFu, v, 1);
        head[o][e] += v;
      }
  }
  if (kq == 0) {
#pragma unroll
    for (int o = 0; o < kOut; ++o)
#pragma unroll
      for (int e = 0; e < 4; ++e) outs[o * kTile + 4 * eq + e] = head[o][e] + b3s[o];
  }
  __syncthreads();

  // 4. One thread per env: the action, the env step, the block, the reset.
  if (tid >= kTile) return;
  const int64_t g = e0 + tid;
  if (g >= batch) return;
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

template <class Env, int kMode>
__global__ void __launch_bounds__(kThreads, 1)
offpolicy_collect_kernel(const float* __restrict__ s_in, int64_t batch, int hidden, Actor w,
                         const float* __restrict__ consts, uint32_t seed,
                         typename Env::Params p, float* __restrict__ s_out,
                         float* __restrict__ block) {
  collect_body<Env, kMode, false>(s_in, batch, hidden, w, consts, seed, p, s_out, block,
                                  nullptr);
}

// The counting kernel (not on any training path): K7 with counts[env] += the
// tether was taut at the start of the step.
template <class Env, int kMode>
__global__ void __launch_bounds__(kThreads, 1)
offpolicy_collect_count_kernel(const float* __restrict__ s_in, int64_t batch, int hidden,
                               Actor w, const float* __restrict__ consts, uint32_t seed,
                               typename Env::Params p, float* __restrict__ s_out,
                               float* __restrict__ block, int* __restrict__ counts) {
  collect_body<Env, kMode, true>(s_in, batch, hidden, w, consts, seed, p, s_out, block, counts);
}

template <class Env, int kMode>
cudaError_t launch_mode(const float* s_in, int64_t batch, int hidden, const Actor& w,
                        const float* consts, uint32_t seed, const float* params_host,
                        float* s_out, float* block, int* counts, cudaStream_t st) {
  constexpr int kOut = (kMode == kSac || kMode == kSacDet) ? 2 * Env::kA : Env::kA;
  const size_t bytes = smem_bytes(Env::kD, hidden, kOut);
  const auto blocks = static_cast<unsigned int>((batch + kTile - 1) / kTile);
  const typename Env::Params p = Env::params(params_host);
  if (counts != nullptr) {
    if constexpr (Env::kTether) {
      auto kernel = offpolicy_collect_count_kernel<Env, kMode>;
      cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
      if (err != cudaSuccess) return err;
      kernel<<<blocks, kThreads, bytes, st>>>(s_in, batch, hidden, w, consts, seed, p, s_out,
                                              block, counts);
      return cudaGetLastError();
    } else {
      return cudaErrorInvalidValue;
    }
  }
  auto kernel = offpolicy_collect_kernel<Env, kMode>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  kernel<<<blocks, kThreads, bytes, st>>>(s_in, batch, hidden, w, consts, seed, p, s_out, block);
  return cudaGetLastError();
}

template <class Env>
cudaError_t launch_env(int mode, const float* s_in, int64_t batch, int hidden, const Actor& w,
                       const float* consts, uint32_t seed, const float* params_host,
                       int n_params, float* s_out, float* block, int* counts, cudaStream_t st) {
  if (n_params != Env::kParams) return cudaErrorInvalidValue;
  switch (mode) {
    case kSac:
      return launch_mode<Env, kSac>(s_in, batch, hidden, w, consts, seed, params_host, s_out,
                                    block, counts, st);
    case kSacDet:
      return launch_mode<Env, kSacDet>(s_in, batch, hidden, w, consts, seed, params_host, s_out,
                                       block, counts, st);
    case kTd3:
      return launch_mode<Env, kTd3>(s_in, batch, hidden, w, consts, seed, params_host, s_out,
                                    block, counts, st);
    case kTd3Det:
      return launch_mode<Env, kTd3Det>(s_in, batch, hidden, w, consts, seed, params_host, s_out,
                                       block, counts, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// C interface, bound with ctypes (reinmav_tpu_torch/_build.py).  Launches on
// the given stream, does not synchronise, and returns a CUDA error code.
// env_kind: a kind id of env_kinds.cuh (0 quadrotor3d-v0, 1
// MujocoQuadForce-v1, 2 quadrotor2d-v0, 3 quadrotor2d-slungload-v0, 4
// quadrotor3d-slungload-v0), params_host the floats of its params vector,
// states (D, B).  mode: 0 sac, 1 sac_det, 2 td3, 3 td3_det (the head w3 is
// (H, 2A) for sac, (H, A) for td3).  hidden: the
// width H of both hidden layers, a multiple of 32 from 32 to 256.  Any other
// kind, mode, width or number of params is refused with
// cudaErrorInvalidValue and nothing runs.  Outputs: states_out (D, B) and
// block (2D + A + 2, B), float32.  counts: null (every training path), or B
// int32 to which each env's taut tether at the start of the step (0 or 1)
// is added (the slung-load kinds; refused for another kind).
extern "C" int offpolicy_collect_launch(int env_kind, int mode, const void* params_host,
                                        int n_params, const void* states_in, long long batch,
                                        int hidden, const void* w1, const void* b1,
                                        const void* w2, const void* b2, const void* w3,
                                        const void* b3, const void* consts, unsigned int seed,
                                        void* states_out, void* block, void* counts,
                                        void* stream) {
  if (batch <= 0 || hidden < kChunk || hidden > kMaxHidden || hidden % kChunk != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
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
    return launch_env<decltype(env)>(mode, s_in, batch, hidden, w, c, seed, h, n_params, s_out,
                                     blk, static_cast<int*>(counts), st);
  });
  return static_cast<int>(err);
}
