// K4: the whole PPO update phase (epochs x minibatches of the loss gradient,
// clip-by-global-norm and Adam, and the optional log-std floor) in ONE
// cooperative launch, written for NVIDIA Hopper (sm_90a); built for the
// (obs, action) dims of ppo_loss_body.cuh::with_kernel_dims, as K3.
//
// Replaces reinmav_tpu/ops/pallas_ppo_update.py::ppo_update_pallas (:304,
// pallas_call :382; body _update_kernel :150-294).  The TPU kernel walks a
// sequential grid on one core with the parameters, Adam moments and
// gradient accumulator resident in VMEM, packed into one (R, 2H) plane with
// structure masks for the fused layer's zero blocks (pack_plane,
// unpack_plane, _structure_masks :90-147).  None of that is ported: the
// port's flat parameter vector (actor_critic.cuh) never stores the zero
// blocks, so the optimiser runs elementwise on the real parameters and no
// mask is needed.
//
// What bounds it on the card: arithmetic.  Each of the E * M passes is K3's
// work on one minibatch (56,192 FP32 operations per sample, ppo_loss.cu);
// the optimiser touches 4 vectors of ~10k floats per pass, which is
// negligible.  At 32,768 envs x 32 steps and 4 x 4 passes that is 2.36e11
// operations, 3.52 ms at 67 TFLOP/s.
//
// What the design does about it: a persistent cooperative grid, K3's grid
// (min(sub-blocks of 128, SMs) CTAs of 256 threads, 215 KiB of shared
// memory at D = 10, about 1 KiB more per obs dim, one CTA per SM), that
// stays resident for the whole update and runs K3's body of register-tiled
// products (ppo_loss_body.cuh), so the host
// issues one launch in place of 16 loss launches, 16 reductions and 16
// optimiser steps.  Per pass p (minibatch p of the epoch-concatenated
// permutation):
//   1. every CTA loads the current parameters from global memory (through
//      L2: other CTAs wrote them in pass p - 1) and runs the shared body
//      (ppo_loss_body.cuh) over its sub-blocks of pass p, writing its
//      partial sums;                                             grid sync
//   2. CTA b adds the partials of a fixed slice of the entries across the
//      CTAs in block order (K3's reduction, so pass 0's gradient is
//      bitwise K3's), scales by 1/n, subtracts ent_coef on the log-std
//      entries, and writes its slice's sum of g^2 to slot b;     grid sync
//   3. every CTA adds the slots in the same order (the global norm), then
//      applies clip-by-global-norm, Adam and the log-std floor to its slice
//      of params, mu and nu in global memory;                    grid sync
// No sum uses atomics, so a rerun is bitwise equal.  The Adam count and
// the adaptive-KL coefficient are read from device scalars, and CTA 0
// writes count + E * M at the end, so the host reads neither.
//
// The host side (the arguments, the cooperative launch) is
// ppo_update_host.cuh's, shared with the wide instances (ppo_update_wide.cu);
// phases 2 and 3 stay in each kernel (see there).  The optimiser is the
// port's ClipAdam (rl/ppo.py), optax's
// chain(clip_by_global_norm(c), adam(lr, eps)): g * (c / |g|) only when
// |g| >= c, eps outside the square root, and the bias corrections
// 1 - beta^t computed in double, then rounded to float.  Its products and
// sums are written with the _rn intrinsics, so that nvcc contracts none of
// them into an FMA that PyTorch's separate operations do not make.
//
// Metrics: the sums [pg, v, kl, clipfrac] over every processed sample, the
// entropy of the pre-step log-std summed over passes, and the KL sum over
// the last epoch's passes (lane 5 of the TPU kernel, :240-246), for the
// adaptive-KL rule.  The per-pass advantage [shift, inv_scale] comes from
// the caller, as in the JAX package.
//
// compute_dtype "bfloat16" (the TPU kernel's default, pallas_ppo_update.py:
// 311, cd :337) launches the kBf instance: K3's bf16 body on the tensor
// cores in every pass (ppo_loss_body_bf16.cuh: mma.sync m16n8k16 bf16 but
// the first layer, 64 samples a sub-block, one tower's chain of 16 samples
// a warp in registers), the weights rounded once as each pass stages them
// from the float32 params; the params, the Adam moments and the
// optimiser's arithmetic stay float32, and the reduction across CTAs is
// the float32 instances'.  Its bound is the products at 989 TFLOP/s; the
// tanhf, the loss and the barriers of each sub-block, and the 3 grid
// barriers a pass, stand above it.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>
#include <type_traits>

#include "ppo_loss_body.cuh"
#include "ppo_loss_body_bf16.cuh"
#include "ppo_update_host.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace reinmav::ppo_loss;
namespace tc = reinmav::ppo_loss_bf16;
namespace pu = reinmav::ppo_update;

// The shared memory of a pass's body: the float32 body's, or the bf16
// body's (kBf).
template <int kD, int kA, bool kBf>
using PassSmem = std::conditional_t<kBf, tc::Smem<kD, kA>, Smem<kD, kA>>;

// 256 floats of block scratch, free between the body's runs.
template <int kD, int kA>
__device__ __forceinline__ float* scratch(Smem<kD, kA>& sm) {
  return &sm.red[0][0];
}
using tc::scratch;

constexpr int kMetrics = 8;  // [pg, v, kl, clipfrac, entropy, kl of the last epoch, 0, 0]

struct UpdateArgs {
  const float* data;       // (rows, n) stacked batch
  int64_t n;
  const int* perm;         // (n_passes * tpm,) shuffle-tile ids, pass order
  const float* adv_stats;  // (n_passes, 2) [shift, inv_scale]
  const float* kl_beta;    // device scalar, read in KL mode only
  const int* count_in;     // Adam count before the update
  int* count_out;          // count_in + n_passes
  float* params;           // (NET,), updated in place
  float* mu;
  float* nu;
  float* partials;         // (gridDim.x, kOut) scratch
  float* gbuf;             // (NET,) scratch: the finished gradient of a pass
  float* slots;            // (gridDim.x,) scratch: each CTA's sum of g^2
  float* metrics;          // (kMetrics,) raw sums
  float* grad0;            // (NET,) pass 0's finished gradient, or nullptr
  int tile, tpm, n_passes, n_minibatches;
  LossCfg loss;
  float inv_n, ent_coef, ent_const, neg_lr, max_norm;
  float b1, one_m_b1, b2, one_m_b2, eps;
  double b1d, b2d;
  int has_floor;
  float log_std_floor;
};

template <int kD, int kA, bool kKl, bool kBf>
__global__ void __launch_bounds__(kThreads, 1) ppo_update_kernel(UpdateArgs a) {
  using L = ac::Layout<kD, kA>;
  constexpr int kOut = out_size<kD, kA>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  PassSmem<kD, kA, kBf>& sm = *reinterpret_cast<PassSmem<kD, kA, kBf>*>(smem_raw);
  cg::grid_group grid = cg::this_grid();
  const int tid = threadIdx.x;
  const int blocks = gridDim.x;
  // This CTA's slice [lo, hi) of the kOut entries (gradient, then metrics).
  const int chunk = (kOut + blocks - 1) / blocks;
  const int lo = min(static_cast<int>(blockIdx.x) * chunk, kOut);
  const int hi = min(lo + chunk, kOut);
  const int hi_net = min(hi, L::kNetSize);
  const int64_t mb = static_cast<int64_t>(a.tpm) * a.tile;
  const int count0 = *a.count_in;
  const float kl_beta = kKl ? *a.kl_beta : 0.0f;
  float* out = a.partials + static_cast<int64_t>(blockIdx.x) * kOut;
  float* const red = scratch(sm);

  float metric_acc = 0.0f;  // the metric entry this thread owns, if any
  float kl_last = 0.0f;     // the owner of the KL entry: its last-epoch sum
  float ent_acc = 0.0f;     // CTA 0, thread 0

  for (int p = 0; p < a.n_passes; ++p) {
    // ---- 1. the loss gradient of pass p, with the weights Adam wrote ----
    if constexpr (kBf) {
      tc::load_weights<kD, kA>(sm, a.params);
    } else {
      load_weights<kD, kA, kBf>(sm, a.params);
    }
    __syncthreads();
    if (blockIdx.x == 0 && tid == 0) {
      float ent = 0.0f;
#pragma unroll
      for (int i = 0; i < kA; ++i) ent += sm.ls[i] + a.ent_const;
      ent_acc += ent;
    }
    if constexpr (kBf) {
      tc::loss_body<kD, kA, kKl>(sm, a.data, a.n, a.perm + static_cast<int64_t>(p) * a.tpm, mb,
                                 a.tile, a.adv_stats[2 * p], a.adv_stats[2 * p + 1], kl_beta,
                                 a.loss, out);
    } else {
      loss_body<kD, kA, kKl, kBf>(sm, a.data, a.n, a.perm + static_cast<int64_t>(p) * a.tpm, mb, a.tile,
                             a.adv_stats[2 * p], a.adv_stats[2 * p + 1], kl_beta, a.loss, out);
    }
    grid.sync();

    // ---- 2. this CTA's slice of the gradient, and its sum of g^2 ---------
    float sq = 0.0f;
    for (int e = lo + tid; e < hi; e += kThreads) {
      float v = 0.0f;
      for (int c = 0; c < blocks; ++c) v += __ldcg(a.partials + static_cast<int64_t>(c) * kOut + e);
      if (e < L::kNetSize) {
        float g = __fmul_rn(v, a.inv_n);
        if (e >= L::kLogStd && e < L::kLogStd + kA) g = __fsub_rn(g, a.ent_coef);
        a.gbuf[e] = g;
        if (p == 0 && a.grad0 != nullptr) a.grad0[e] = g;
        sq += g * g;
      } else {
        metric_acc += v;
        if (e == L::kNetSize + 2 && p >= a.n_passes - a.n_minibatches) kl_last += v;
      }
    }
    red[tid] = sq;
    __syncthreads();
    for (int half = kThreads / 2; half > 0; half >>= 1) {
      if (tid < half) red[tid] += red[tid + half];
      __syncthreads();
    }
    if (tid == 0) a.slots[blockIdx.x] = red[0];
    grid.sync();

    // ---- 3. the global norm, then clip + Adam + floor on the slice -------
    if (tid == 0) {
      float total = 0.0f;
      for (int c = 0; c < blocks; ++c) total += __ldcg(a.slots + c);
      red[0] = total;
    }
    __syncthreads();
    const float gnorm = sqrtf(red[0]);
    const bool clip = !(gnorm < a.max_norm);
    const double t = static_cast<double>(count0) + p + 1;
    const float bc1 = static_cast<float>(1.0 - pow(a.b1d, t));
    const float bc2 = static_cast<float>(1.0 - pow(a.b2d, t));
    for (int e = lo + tid; e < hi_net; e += kThreads) {
      float g = __ldcg(a.gbuf + e);
      if (clip) g = __fmul_rn(__fdiv_rn(g, gnorm), a.max_norm);
      const float m = __fadd_rn(__fmul_rn(a.one_m_b1, g), __fmul_rn(a.b1, __ldcg(a.mu + e)));
      const float v =
          __fadd_rn(__fmul_rn(a.one_m_b2, __fmul_rn(g, g)), __fmul_rn(a.b2, __ldcg(a.nu + e)));
      a.mu[e] = m;
      a.nu[e] = v;
      const float step =
          __fdiv_rn(__fdiv_rn(m, bc1), __fadd_rn(__fsqrt_rn(__fdiv_rn(v, bc2)), a.eps));
      float w = __fadd_rn(__ldcg(a.params + e), __fmul_rn(a.neg_lr, step));
      if (a.has_floor && e >= L::kLogStd && e < L::kLogStd + kA) w = fmaxf(w, a.log_std_floor);
      a.params[e] = w;
    }
    grid.sync();
  }

  // ---- the metric sums, each written by the thread that owns it ----------
  for (int e = lo + tid; e < hi; e += kThreads) {
    if (e >= L::kNetSize) a.metrics[e - L::kNetSize] = metric_acc;
    if (e == L::kNetSize + 2) a.metrics[5] = kl_last;
  }
  if (blockIdx.x == 0 && tid == 0) {
    a.metrics[4] = ent_acc;
    a.metrics[6] = 0.0f;
    a.metrics[7] = 0.0f;
    *a.count_out = count0 + a.n_passes;
  }
}

template <int kD, int kA, bool kKl, bool kBf>
cudaError_t launch(const UpdateArgs& args, int blocks, cudaStream_t stream) {
  const int smem = static_cast<int>(sizeof(PassSmem<kD, kA, kBf>));
  const void* kern = reinterpret_cast<const void*>(ppo_update_kernel<kD, kA, kKl, kBf>);
  return pu::launch_cooperative(kern, kThreads, smem, args, blocks, stream);
}

}  // namespace

// C interface, bound with ctypes (reinmav_tpu_torch/_build.py).  Launches on
// the given stream, does not synchronise, and returns a CUDA error code:
// cudaErrorCooperativeLaunchTooLarge when the grid cannot be co-resident
// (the caller raises; there is no fallback), cudaErrorInvalidValue for
// (obs, action) dims (d, adim) that with_kernel_dims does not list (nothing
// runs).  data (d + adim + 4, n) f32; perm
// (n_passes * tpm,) int32 tile ids; adv_stats (n_passes, 2) f32; kl_beta
// f32 and count_in int32 device scalars; params, mu, nu (NET,) f32 updated
// in place; count_out int32 scalar; partials (blocks, NET + 4), gbuf (NET,),
// slots (blocks,) f32 scratch; metrics (8,) raw sums; grad0 (NET,) or null;
// bf16 nonzero launches the bf16 instance.
extern "C" int ppo_update_launch(int d, int adim, const void* data, long long n, const void* perm, int tile,
                                 int tpm, int n_passes, int n_minibatches, const void* adv_stats,
                                 const void* kl_beta, const void* count_in, void* count_out,
                                 void* params, void* mu, void* nu, float clip_eps,
                                 float value_clip_eps, float value_coef, double inv_n,
                                 float ent_coef, float lr, float max_norm, double b1, double b2,
                                 float eps, int has_floor, float log_std_floor, int kl_mode,
                                 int bf16, int blocks, void* partials, void* gbuf, void* slots, void* metrics,
                                 void* grad0, void* stream) {
  UpdateArgs a{};
  pu::set_update_args(a, data, n, perm, tile, tpm, n_passes, n_minibatches, adv_stats, kl_beta,
                      count_in, count_out, params, mu, nu, inv_n, ent_coef, lr, max_norm, b1, b2,
                      eps, has_floor, log_std_floor, partials, gbuf, slots, metrics, grad0);
  a.loss = LossCfg{clip_eps, value_clip_eps, value_coef};
  const auto st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      with_kernel_dims(d, adim, cudaErrorInvalidValue, [&](auto dc, auto ac_) {
        constexpr int kD = decltype(dc)::value, kA = decltype(ac_)::value;
        if (bf16) {
          return kl_mode ? launch<kD, kA, true, true>(a, blocks, st)
                         : launch<kD, kA, false, true>(a, blocks, st);
        }
        return kl_mode ? launch<kD, kA, true, false>(a, blocks, st)
                       : launch<kD, kA, false, false>(a, blocks, st);
      });
  return static_cast<int>(err);
}

// The number of metric sums ppo_update_launch writes.
extern "C" int ppo_update_metrics_size() { return kMetrics; }
