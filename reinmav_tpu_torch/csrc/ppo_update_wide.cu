// K4 wide: the whole PPO update phase (epochs x minibatches of the loss
// gradient, clip-by-global-norm and Adam, and the optional log-std floor) in
// ONE cooperative launch, for a tanh actor-critic of two equal hidden
// layers of any width from 1 to 256, written for NVIDIA Hopper (sm_90a).
// The widths are kernel arguments; the instances are the KL switch x the
// dtype.  ops/ppo_update.py dispatches here every width that the 64-wide
// instances (ppo_update.cu) do not take.
//
// Replaces reinmav_tpu/ops/pallas_ppo_update.py::ppo_update_pallas (:304,
// pallas_call :382) at those widths, as ppo_update.cu does at 64, with the
// same contract: no atomics (a rerun is bitwise equal), the Adam count and
// the adaptive-KL coefficient read from device scalars and count + E * M
// written by CTA 0, so the host reads neither.
//
// What bounds it: FP32 arithmetic, the E * M passes of K3 wide's work (about
// 8.2e5 operations a sample at H = 256, D = 10: 51 ms for a 4 x 4 update at
// 32,768 x 32 at 67 TFLOP/s); the optimiser's 4 vectors of NET floats a pass
// are small beside it.
//
// Design: a persistent cooperative grid of K3 wide's CTAs (one of 256
// threads an SM), resident for the whole update.  Per pass p:
//   1. every CTA stages the current biases and heads and runs the wide body
//      (ppo_loss_body_wide.cuh) over its sub-blocks of pass p, the weights
//      read through L2 (other CTAs wrote them in pass p - 1), its partial
//      sums in its own row;                                     grid sync
//   2. CTA b adds the partials of a fixed slice of the entries across the
//      CTAs in block order (so pass 0's gradient is bitwise K3 wide's),
//      scales by 1/n, subtracts ent_coef on the log-std entries, and writes
//      its slice's sum of g^2 to slot b;                         grid sync
//   3. every CTA adds the slots in the same order (the global norm), then
//      applies clip-by-global-norm, Adam and the log-std floor to its slice
//      of params, mu and nu;                                     grid sync
// Phases 2 and 3 are ppo_update.cu's, operation for operation: the port's
// ClipAdam (rl/ppo.py), the bias corrections in double, every product and
// sum with the _rn intrinsics; the host side is shared with it
// (ppo_update_host.cuh).  The two phases are a copy, not a shared device
// function: moved into a header as a __forceinline__ function, called by
// both kernels with the 64-wide kernel's constants as arguments, they
// changed the SASS of all 20 of ppo_update.cu's instances (float32 and
// bf16, every (obs, action) pair; NVIDIA H100 80GB HBM3, sass_report
// --against the unshared build), so the 64-wide kernel keeps its own.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

#include "ppo_loss_body_wide.cuh"
#include "ppo_update_host.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace reinmav::ppo_wide;
namespace pu = reinmav::ppo_update;

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
  float* partials;         // (gridDim.x, NET + 4) scratch
  float* gbuf;             // (NET,) scratch: the finished gradient of a pass
  float* slots;            // (gridDim.x,) scratch: each CTA's sum of g^2
  float* metrics;          // (kMetrics,) raw sums
  float* grad0;            // (NET,) pass 0's finished gradient, or nullptr
  int d, adim, h;
  int tile, tpm, n_passes, n_minibatches;
  LossCfg loss;
  float inv_n, ent_coef, ent_const, neg_lr, max_norm;
  float b1, one_m_b1, b2, one_m_b2, eps;
  double b1d, b2d;
  int has_floor;
  float log_std_floor;
};

template <bool kKl, bool kBf>
__global__ void __launch_bounds__(kThreads, 1) ppo_update_wide_kernel(UpdateArgs a) {
  extern __shared__ __align__(16) float smem[];
  const Shape sh = make_shape(a.d, a.adim, a.h);
  const reinmav::ac::RtLayout L(a.d, a.adim, a.h);
  const int n_out = L.net_size + 4;
  cg::grid_group grid = cg::this_grid();
  const int tid = threadIdx.x;
  const int blocks = gridDim.x;
  // This CTA's slice [lo, hi) of the n_out entries (gradient, then metrics).
  const int chunk = (n_out + blocks - 1) / blocks;
  const int lo = min(static_cast<int>(blockIdx.x) * chunk, n_out);
  const int hi = min(lo + chunk, n_out);
  const int hi_net = min(hi, L.net_size);
  const int64_t mb = static_cast<int64_t>(a.tpm) * a.tile;
  const int count0 = *a.count_in;
  const float kl_beta = kKl ? *a.kl_beta : 0.0f;
  float* out = a.partials + static_cast<int64_t>(blockIdx.x) * n_out;
  float* const red = smem + sh.wst;  // 256 floats of block scratch between the body's runs

  float metric_acc = 0.0f;  // the metric entry this thread owns, if any
  float kl_last = 0.0f;     // the owner of the KL entry: its last-epoch sum
  float ent_acc = 0.0f;     // CTA 0, thread 0

  for (int p = 0; p < a.n_passes; ++p) {
    // ---- 1. the loss gradient of pass p, with the weights Adam wrote ----
    load_small<kBf>(smem, sh, L, a.params);
    __syncthreads();
    if (blockIdx.x == 0 && tid == 0) {
      float ent = 0.0f;
      for (int i = 0; i < sh.A; ++i) ent += smem[sh.ls + i] + a.ent_const;
      ent_acc += ent;
    }
    loss_body<kKl, kBf>(smem, sh, L, a.params, a.data, a.n,
                        a.perm + static_cast<int64_t>(p) * a.tpm, mb, a.tile,
                        a.adv_stats[2 * p], a.adv_stats[2 * p + 1], kl_beta, a.loss, out);
    grid.sync();

    // ---- 2. this CTA's slice of the gradient, and its sum of g^2 ---------
    float sq = 0.0f;
    for (int e = lo + tid; e < hi; e += kThreads) {
      float v = 0.0f;
      for (int c = 0; c < blocks; ++c) v += __ldcg(a.partials + static_cast<int64_t>(c) * n_out + e);
      if (e < L.net_size) {
        float g = __fmul_rn(v, a.inv_n);
        if (e < sh.A) g = __fsub_rn(g, a.ent_coef);  // the log-std entries, at 0
        a.gbuf[e] = g;
        if (p == 0 && a.grad0 != nullptr) a.grad0[e] = g;
        sq += g * g;
      } else {
        metric_acc += v;
        if (e == L.net_size + 2 && p >= a.n_passes - a.n_minibatches) kl_last += v;
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
      if (a.has_floor && e < sh.A) w = fmaxf(w, a.log_std_floor);
      a.params[e] = w;
    }
    grid.sync();
  }

  // ---- the metric sums, each written by the thread that owns it ----------
  for (int e = lo + tid; e < hi; e += kThreads) {
    if (e >= L.net_size) a.metrics[e - L.net_size] = metric_acc;
    if (e == L.net_size + 2) a.metrics[5] = kl_last;
  }
  if (blockIdx.x == 0 && tid == 0) {
    a.metrics[4] = ent_acc;
    a.metrics[6] = 0.0f;
    a.metrics[7] = 0.0f;
    *a.count_out = count0 + a.n_passes;
  }
}

template <bool kKl, bool kBf>
cudaError_t launch(const UpdateArgs& args, int blocks, cudaStream_t stream) {
  const int smem = smem_bytes(make_shape(args.d, args.adim, args.h));
  const void* kern = reinterpret_cast<const void*>(ppo_update_wide_kernel<kKl, kBf>);
  return pu::launch_cooperative(kern, kThreads, smem, args, blocks, stream);
}

}  // namespace

// C interface, bound with ctypes (reinmav_tpu_torch/_build.py): ppo_update.cu's
// ppo_update_launch with the hidden width h after the obs and action dims.
// Launches on the given stream, does not synchronise, and returns a CUDA
// error code: cudaErrorCooperativeLaunchTooLarge when the grid cannot be
// co-resident (the caller raises; there is no fallback), cudaErrorInvalidValue
// for widths the wide body does not take (nothing runs).  partials (blocks,
// NET + 4) scratch, NET the flat size at width h.
extern "C" int ppo_update_wide_launch(int d, int adim, int h, const void* data, long long n,
                                      const void* perm, int tile, int tpm, int n_passes,
                                      int n_minibatches, const void* adv_stats,
                                      const void* kl_beta, const void* count_in, void* count_out,
                                      void* params, void* mu, void* nu, float clip_eps,
                                      float value_clip_eps, float value_coef, double inv_n,
                                      float ent_coef, float lr, float max_norm, double b1,
                                      double b2, float eps, int has_floor, float log_std_floor,
                                      int kl_mode, int bf16, int blocks, void* partials,
                                      void* gbuf, void* slots, void* metrics, void* grad0,
                                      void* stream) {
  if (!takes(d, adim, h)) return static_cast<int>(cudaErrorInvalidValue);
  UpdateArgs a{};
  pu::set_update_args(a, data, n, perm, tile, tpm, n_passes, n_minibatches, adv_stats, kl_beta,
                      count_in, count_out, params, mu, nu, inv_n, ent_coef, lr, max_norm, b1, b2,
                      eps, has_floor, log_std_floor, partials, gbuf, slots, metrics, grad0);
  a.d = d;
  a.adim = adim;
  a.h = h;
  a.loss = LossCfg{clip_eps, value_clip_eps, value_coef, log_norm(adim)};
  const auto st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = kl_mode ? (bf16 ? launch<true, true>(a, blocks, st)
                                          : launch<true, false>(a, blocks, st))
                                  : (bf16 ? launch<false, true>(a, blocks, st)
                                          : launch<false, false>(a, blocks, st));
  return static_cast<int>(err);
}
