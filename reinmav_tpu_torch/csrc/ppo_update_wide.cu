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
// What bounds it: the E * M passes of K3 wide's products (about 8.1e5
// operations a sample at H = 256, D = 10) on the tensor cores: float32 as
// 3xTF32 (three tf32 products each, so 495 / 3 TFLOP/s), bf16 at 989
// TFLOP/s: 20.7 ms and 3.45 ms for a 4 x 4 update at 32,768 x 32; and the
// 4 H tanhf a sample on the SFUs (2.06 ms).  The optimiser's 4 vectors of
// NET floats a pass are small beside them.  Measured there: 105 ms and 75
// ms (NVIDIA H100 80GB HBM3, 700 W): mma.sync issues about one tf32 product
// each 13 cycles a scheduler, and the bf16 instance recomputes about 1.5%
// of its h's in the twin's order (ppo_loss_body_wide.cuh).
//
// Design: a persistent cooperative grid of K3 wide's CTAs (one of 512
// threads an SM, 132 on an H100 SXM: 66 a tower), resident for the whole
// update.  It packs the params' weights into the body's mma fragments
// (pack_entry) once, then per pass p:
//   1. every CTA stages its tower's biases and head and runs the wide body
//      (ppo_loss_body_wide.cuh) over its sub-blocks of pass p, the weights
//      read from the packed copy that pass p - 1 wrote, its partial sums of
//      its tower's entries in its own row;                       grid sync
//   2. CTA b adds the partials of a fixed slice of the entries across the
//      CTAs of each entry's tower (owner_tower), in block order (so pass 0's
//      gradient is bitwise K3 wide's), scales by 1/n, subtracts ent_coef on
//      the log-std entries, and writes its slice's sum of g^2 to slot b;
//                                                                grid sync
//   3. every CTA adds the slots in the same order (the global norm), then
//      applies clip-by-global-norm, Adam and the log-std floor to its slice
//      of params, mu and nu, and writes each updated weight into the packed
//      copy;                                                     grid sync
// Phases 2 and 3 are ppo_update.cu's, operation for operation: the port's
// ClipAdam (rl/ppo.py), the bias corrections in double, every product and
// sum with the _rn intrinsics; the host side is shared with it
// (ppo_update_host.cuh).  The two phases are a copy, not a shared device
// function: moved into a header as a __forceinline__ function, called by
// both kernels with the 64-wide kernel's constants as arguments, they
// changed the SASS of all 20 of ppo_update.cu's instances (float32 and
// bf16, every (obs, action) pair; NVIDIA H100 80GB HBM3, sass_report
// --against the unshared build), so the 64-wide kernel keeps its own.  This
// copy differs from that one in phase 2's rows (only the owner tower's
// CTAs), its block reduction over 512 threads and phase 3's packing.

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
  uint32_t* packed;        // both towers' packed weights (zeroed), scratch
  uint4* panels;           // (gridDim.x, groups, Shape::group) scratch
  int groups;              // groups_per_cta
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
  const Shape sh = make_shape(a.d, a.adim, a.h, kBf);
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
  float* const red = smem + sh.act0;  // kThreads floats of block scratch between the body's runs
  uint4* const panels = a.panels + static_cast<int64_t>(blockIdx.x) * a.groups * sh.group;

  float metric_acc = 0.0f;  // the metric entry this thread owns, if any
  float kl_last = 0.0f;     // the owner of the KL entry: its last-epoch sum
  float ent_acc = 0.0f;     // CTA 0, thread 0

  // ---- 0. the params' weights into the packed copy, the slice of each CTA -
  for (int e = lo + tid; e < hi_net; e += kThreads) pack_entry<kBf>(sh, L, a.packed, e, a.params[e]);
  grid.sync();

  for (int p = 0; p < a.n_passes; ++p) {
    // ---- 1. the loss gradient of pass p, with the weights Adam wrote ----
    load_small<kBf>(smem, sh, L, a.params, blockIdx.x & 1);
    __syncthreads();
    if (blockIdx.x == 0 && tid == 0) {
      float ent = 0.0f;
      for (int i = 0; i < sh.A; ++i) ent += smem[sh.ls + i] + a.ent_const;
      ent_acc += ent;
    }
    loss_body<kKl, kBf>(smem, sh, L, reinterpret_cast<const uint4*>(a.packed), a.data,
                        a.n, a.perm + static_cast<int64_t>(p) * a.tpm, mb, a.tile,
                        a.adv_stats[2 * p], a.adv_stats[2 * p + 1], kl_beta, a.loss, panels, out,
                        nullptr);
    grid.sync();

    // ---- 2. this CTA's slice of the gradient, and its sum of g^2 ---------
    float sq = 0.0f;
    for (int e = lo + tid; e < hi; e += kThreads) {
      float v = 0.0f;
      for (int c = owner_tower(L, e); c < blocks; c += 2) {
        v += __ldcg(a.partials + static_cast<int64_t>(c) * n_out + e);
      }
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
      pack_entry<kBf>(sh, L, a.packed, e, w);
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
  const int smem = smem_bytes(make_shape(args.d, args.adim, args.h, kBf));
  const void* kern = reinterpret_cast<const void*>(ppo_update_wide_kernel<kKl, kBf>);
  return pu::launch_cooperative(kern, kThreads, smem, args, blocks, stream);
}

}  // namespace

// Resident CTAs an SM of K4 wide's instance (kl_mode, bf16) at widths (d,
// adim, h), from the occupancy query, into *per_sm: the cooperative grid
// needs 1.  A CUDA error code.
extern "C" int ppo_update_wide_occupancy(int d, int adim, int h, int kl_mode, int bf16,
                                         int* per_sm) {
  if (!takes(d, adim, h)) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = smem_bytes(make_shape(d, adim, h, bf16 != 0));
  const void* kern = kl_mode ? (bf16 ? reinterpret_cast<const void*>(ppo_update_wide_kernel<true, true>)
                                     : reinterpret_cast<const void*>(ppo_update_wide_kernel<true, false>))
                             : (bf16 ? reinterpret_cast<const void*>(ppo_update_wide_kernel<false, true>)
                                     : reinterpret_cast<const void*>(ppo_update_wide_kernel<false, false>));
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kern, kThreads,
                                                                        smem));
}

// C interface, bound with ctypes (reinmav_tpu_torch/_build.py): ppo_update.cu's
// ppo_update_launch with the hidden width h after the obs and action dims,
// then the body's plan ((5,) int64 on the host, ppo_wide_plan's first five),
// the packed weights' scratch (plan[4] 16-byte words, zeroed) and the
// panels' (blocks x plan[2] x plan[3] 16-byte words).  Launches on the given
// stream, does not synchronise, and returns a CUDA error code:
// cudaErrorCooperativeLaunchTooLarge when the grid cannot be co-resident
// (the caller raises; there is no fallback), cudaErrorInvalidValue for
// widths the wide body does not take or a plan that is not its own (nothing
// runs).  partials (blocks, NET + 4) scratch, NET the flat size at width h.
extern "C" int ppo_update_wide_launch(int d, int adim, int h, const void* plan, void* packed,
                                      void* panels, const void* data, long long n,
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
  const long long* pl = static_cast<const long long*>(plan);
  if (!plan_ok(d, adim, h, bf16 != 0, static_cast<long long>(tpm) * tile, blocks, pl)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  UpdateArgs a{};
  pu::set_update_args(a, data, n, perm, tile, tpm, n_passes, n_minibatches, adv_stats, kl_beta,
                      count_in, count_out, params, mu, nu, inv_n, ent_coef, lr, max_norm, b1, b2,
                      eps, has_floor, log_std_floor, partials, gbuf, slots, metrics, grad0);
  a.d = d;
  a.adim = adim;
  a.h = h;
  a.packed = static_cast<uint32_t*>(packed);
  a.panels = static_cast<uint4*>(panels);
  a.groups = static_cast<int>(pl[2]);
  a.loss = LossCfg{clip_eps, value_clip_eps, value_coef, log_norm(adim)};
  const auto st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = kl_mode ? (bf16 ? launch<true, true>(a, blocks, st)
                                          : launch<true, false>(a, blocks, st))
                                  : (bf16 ? launch<false, true>(a, blocks, st)
                                          : launch<false, false>(a, blocks, st));
  return static_cast<int>(err);
}
