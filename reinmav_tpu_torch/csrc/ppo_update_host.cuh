// K4's host side, shared by the 64-wide instances (ppo_update.cu) and the
// wide ones (ppo_update_wide.cu): the C interface's arguments into each
// kernel's argument struct (the same fields; the wide one adds the widths
// and its own LossCfg), and the cooperative launch.  Phases 2 and 3 of a
// pass (the reduction, clip and Adam) are device code and stay in each
// kernel: shared as a device function they changed the 64-wide instances'
// SASS (ppo_update_wide.cu says how).

#pragma once

#include <cuda_runtime.h>

#include <cmath>

namespace reinmav {
namespace ppo_update {

// The C interface's arguments that both kernels take, into their structs.
template <class Args>
void set_update_args(Args& a, const void* data, long long n, const void* perm, int tile, int tpm,
                     int n_passes, int n_minibatches, const void* adv_stats, const void* kl_beta,
                     const void* count_in, void* count_out, void* params, void* mu, void* nu,
                     double inv_n, float ent_coef, float lr, float max_norm, double b1,
                     double b2, float eps, int has_floor, float log_std_floor, void* partials,
                     void* gbuf, void* slots, void* metrics, void* grad0) {
  a.data = static_cast<const float*>(data);
  a.n = n;
  a.perm = static_cast<const int*>(perm);
  a.adv_stats = static_cast<const float*>(adv_stats);
  a.kl_beta = static_cast<const float*>(kl_beta);
  a.count_in = static_cast<const int*>(count_in);
  a.count_out = static_cast<int*>(count_out);
  a.params = static_cast<float*>(params);
  a.mu = static_cast<float*>(mu);
  a.nu = static_cast<float*>(nu);
  a.partials = static_cast<float*>(partials);
  a.gbuf = static_cast<float*>(gbuf);
  a.slots = static_cast<float*>(slots);
  a.metrics = static_cast<float*>(metrics);
  a.grad0 = static_cast<float*>(grad0);
  a.tile = tile;
  a.tpm = tpm;
  a.n_passes = n_passes;
  a.n_minibatches = n_minibatches;
  a.inv_n = static_cast<float>(inv_n);
  a.ent_coef = ent_coef;
  // networks.entropy: sum over the log-std of (log_std + 0.5 log(2 pi e)).
  const double two_pi_e = 2.0 * 3.14159265358979323846 * 2.71828182845904523536;
  a.ent_const = static_cast<float>(0.5 * std::log(two_pi_e));
  a.neg_lr = -lr;
  a.max_norm = max_norm;
  // As PyTorch rounds the Python scalars of ClipAdam: 1 - b in double, then float.
  a.b1 = static_cast<float>(b1);
  a.one_m_b1 = static_cast<float>(1.0 - b1);
  a.b2 = static_cast<float>(b2);
  a.one_m_b2 = static_cast<float>(1.0 - b2);
  a.eps = eps;
  a.b1d = b1;
  a.b2d = b2;
  a.has_floor = has_floor;
  a.log_std_floor = log_std_floor;
}

// One cooperative launch of kern (threads a CTA, smem bytes of dynamic
// shared memory) over blocks CTAs; cudaErrorCooperativeLaunchTooLarge when
// they cannot be co-resident, or grid.sync() would wait forever.
template <class Args>
cudaError_t launch_cooperative(const void* kern, int threads, int smem, const Args& args,
                               int blocks, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev)) != cudaSuccess)
    return err;
  if (!coop) return cudaErrorNotSupported;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, threads, smem);
  if (err != cudaSuccess) return err;
  if (blocks < 1 || static_cast<long long>(per_sm) * sms < blocks)
    return cudaErrorCooperativeLaunchTooLarge;
  Args a = args;
  void* kernel_args[] = {&a};
  err = cudaLaunchCooperativeKernel(kern, dim3(blocks), dim3(threads), kernel_args,
                                    static_cast<size_t>(smem), stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace ppo_update
}  // namespace reinmav
