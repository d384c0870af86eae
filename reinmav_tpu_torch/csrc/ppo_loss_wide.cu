// K3 wide: the PPO loss forward and hand-derived backward over one minibatch
// of a tanh actor-critic of two equal hidden layers of any width from 1 to
// 256, the minibatch gathered in the kernel, written for NVIDIA Hopper
// (sm_90a).  The widths (obs D <= 32, action A <= 8, hidden H) are kernel
// arguments: the instances are the KL switch x the dtype, four in all.
// ops/ppo_loss.py dispatches here every width that the 64-wide instances
// (ppo_loss.cu, built for hidden 64 at the dims of with_kernel_dims) do not
// take.
//
// Replaces reinmav_tpu/ops/pallas_ppo.py::ppo_loss_grads_pallas_gather
// (:424; pallas_call :312) at those widths, as ppo_loss.cu does at 64: the
// JAX kernel takes any two equal widths.  Output: raw SUMS over the
// minibatch in the flat parameter layout (actor_critic.cuh::RtLayout), then
// the 4 metric sums; the caller scales by 1/n and adds the entropy term
// (ops/ppo_loss.py::_finish).  Its twin is ops/ppo_loss.py::
// ppo_loss_grads_reference, generic in width.
//
// What bounds it: FP32 arithmetic, about 2 (6 H^2 + 4 D H + 5 H) operations a
// sample (8.2e5 at H = 256, D = 10: 3.2 ms a 262,144-sample minibatch at 67
// TFLOP/s), and the 4 H tanhf a sample on the SFUs.  The design
// (ppo_loss_body_wide.cuh): one CTA of 256 threads an SM, sub-blocks of
// S samples chosen from H, 8 x 8 register-tiled products over weight rows
// staged through shared memory, and each weight-gradient entry summed into
// the CTA's row of partial sums in global memory by the thread that owns
// it.  A second launch adds the CTAs' rows in block order, one thread an
// entry, so a rerun is bitwise equal.
//
// compute_dtype "bfloat16" launches the kBf instances: every product's
// operands rounded to bf16, the exact products summed in float32 on the FP32
// pipes (the twin's bf16_mm), not yet on the tensor cores.

#include <cuda_runtime.h>
#include <stdint.h>

#include "ppo_loss_body_wide.cuh"

namespace {

using namespace reinmav::ppo_wide;

struct WideArgs {
  const float* data;
  int64_t n;
  const int* perm;
  int64_t mb;
  int tile;
  const float* adv_stats;  // [shift, inv_scale, kl_beta, 0]
  const float* net;
  float* partials;  // (gridDim.x, NET + 4)
  int d, adim, h;
  LossCfg cfg;
};

template <bool kKl, bool kBf>
__global__ void __launch_bounds__(kThreads, 1) ppo_loss_wide_kernel(WideArgs a) {
  extern __shared__ __align__(16) float smem[];
  const Shape sh = make_shape(a.d, a.adim, a.h);
  const reinmav::ac::RtLayout L(a.d, a.adim, a.h);
  load_small<kBf>(smem, sh, L, a.net);
  const float adv_shift = a.adv_stats[0], adv_inv = a.adv_stats[1], kl_beta = a.adv_stats[2];
  __syncthreads();
  loss_body<kKl, kBf>(smem, sh, L, a.net, a.data, a.n, a.perm, a.mb, a.tile, adv_shift, adv_inv,
                      kl_beta, a.cfg,
                      a.partials + static_cast<int64_t>(blockIdx.x) * (L.net_size + 4));
}

// out[e] = the CTAs' partials of entry e, added in block order.
__global__ void ppo_wide_reduce_kernel(const float* __restrict__ partials, int blocks, int n_out,
                                       float* __restrict__ out) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n_out) return;
  float v = 0.0f;
  for (int b = 0; b < blocks; ++b) v += partials[static_cast<int64_t>(b) * n_out + e];
  out[e] = v;
}

template <bool kKl, bool kBf>
cudaError_t launch(const WideArgs& a, int blocks, cudaStream_t stream) {
  const int smem = smem_bytes(make_shape(a.d, a.adim, a.h));
  cudaError_t err = cudaFuncSetAttribute(ppo_loss_wide_kernel<kKl, kBf>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  ppo_loss_wide_kernel<kKl, kBf><<<blocks, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// The number of CTAs ppo_loss_wide_launch uses for a minibatch of mb
// samples at hidden width h: one per sub-block of sub_block_samples(h), at
// most one per SM.  -1 on a CUDA error.
extern "C" int ppo_loss_wide_blocks(long long mb, int h) {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return -1;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) return -1;
  const int s = sub_block_samples(h < 1 ? 1 : h);
  const long long sub = (mb + s - 1) / s;
  return static_cast<int>(sub < sms ? sub : sms);
}

// The sums ppo_loss_wide_launch writes for widths (d, adim, h): the flat
// gradient, then the 4 metrics; -1 for widths the wide body does not take.
extern "C" int ppo_loss_wide_out_size(int d, int adim, int h) {
  return takes(d, adim, h) ? reinmav::ac::RtLayout(d, adim, h).net_size + 4 : -1;
}

// The wide body's dynamic shared memory in bytes at (d, adim, h), and its
// samples a sub-block in *samples; -1 for widths it does not take.
extern "C" int ppo_wide_smem(int d, int adim, int h, int* samples) {
  if (!takes(d, adim, h)) return -1;
  const Shape sh = make_shape(d, adim, h);
  *samples = sh.S;
  return smem_bytes(sh);
}

// actor_critic.cuh::RtLayout's offsets at (d, adim, h) into out[11]: w1, b2,
// w2, tower_hidden (inside a tower), pi, pi_out_b, pi_out_w, vf, vf_out_b,
// vf_out_w, net_size; 0, or -1 for widths the wide body does not take.
extern "C" int ppo_wide_layout(int d, int adim, int h, int* out) {
  if (!takes(d, adim, h)) return -1;
  const reinmav::ac::RtLayout L(d, adim, h);
  const int v[11] = {L.w1, L.b2, L.w2, L.tower_hidden, L.pi, L.pi_out_b, L.pi_out_w,
                     L.vf, L.vf_out_b, L.vf_out_w, L.net_size};
  for (int i = 0; i < 11; ++i) out[i] = v[i];
  return 0;
}

// C interface, bound with ctypes (reinmav_tpu_torch/_build.py).  Launches on
// the given stream, does not synchronise, and returns a CUDA error code
// (cudaErrorInvalidValue, nothing run, for widths the wide body does not
// take).  data (d + adim + 4, n) f32; perm (m,) int32 tile indices;
// adv_stats (4,) f32 [adv shift, adv inverse scale, kl beta, 0]; net the
// flat parameters at hidden width h; partials (blocks, NET + 4) scratch; out
// (NET + 4,) raw sums; bf16 nonzero launches the bf16 instance.
extern "C" int ppo_loss_wide_launch(int d, int adim, int h, const void* data, long long n,
                                    const void* perm, long long m, int tile,
                                    const void* adv_stats, const void* net, float clip_eps,
                                    float value_clip_eps, float value_coef, int kl_mode, int bf16,
                                    int blocks, void* partials, void* out, void* stream) {
  if (!takes(d, adim, h) || blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  WideArgs a{};
  a.data = static_cast<const float*>(data);
  a.n = n;
  a.perm = static_cast<const int*>(perm);
  a.mb = m * tile;
  a.tile = tile;
  a.adv_stats = static_cast<const float*>(adv_stats);
  a.net = static_cast<const float*>(net);
  a.partials = static_cast<float*>(partials);
  a.d = d;
  a.adim = adim;
  a.h = h;
  a.cfg = LossCfg{clip_eps, value_clip_eps, value_coef, log_norm(adim)};
  cudaError_t err = kl_mode ? (bf16 ? launch<true, true>(a, blocks, st)
                                    : launch<true, false>(a, blocks, st))
                            : (bf16 ? launch<false, true>(a, blocks, st)
                                    : launch<false, false>(a, blocks, st));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_out = reinmav::ac::RtLayout(d, adim, h).net_size + 4;
  ppo_wide_reduce_kernel<<<(n_out + 255) / 256, 256, 0, st>>>(a.partials, blocks, n_out,
                                                              static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
