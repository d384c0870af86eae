// K3: the PPO loss forward and hand-derived backward over one minibatch of
// the 2x64 tanh actor-critic, with the minibatch gathered in the kernel,
// written for NVIDIA Hopper (sm_90a); built for the (obs, action) dims of
// ppo_loss_body.cuh::with_kernel_dims: (10, 4) quadrotor3d-v0, (13, 4) the
// tpuquad family, (5, 2) quadrotor2d-v0, (9, 2) and (16, 4) the slung-load
// envs.
//
// Replaces reinmav_tpu/ops/pallas_ppo.py::ppo_loss_grads_pallas_gather
// (:424) and ppo_loss_grads_pallas (:377): _tile_loss_grads (:71-173) over
// the samples that _kernel (:176-255) gathers by shuffle-tile index.  The
// clipped or adaptive-KL surrogate, value clipping, JAX's tie conventions
// for minimum / maximum (sel1/sel2/tie :121-127, vs1/vs2/vtie :136-141), the
// log-std gradient, and the metric sums [pg, v, kl, clipfrac].  Output: raw
// SUMS over the minibatch in the flat parameter layout (actor_critic.cuh),
// then the 4 metric sums; the caller scales by 1/n and adds the entropy term
// (ops/ppo_loss.py::_finish).  Its plain PyTorch twin, the same hand-derived
// backward in eager torch, is reinmav_tpu_torch/ops/ppo_loss.py::
// ppo_loss_grads_reference.
//
// What bounds it on the card: arithmetic.  A sample costs about 28k FMA at
// D = 10 (forward 9.8k, the two towers' backward products 2 * 4096 for dh1
// and 2 * 4096 for dW2, dW1 1280 and the heads), 56k FP32 operations, and
// 57.7k at D = 13 (2 * (28,096 + 128 (D - 10) + 320 (A - 4)) in general),
// against 4 * (D + A + 4) B of input; the zero blocks of the fused layer are
// not computed.
//
// What the design does about it: the per-CTA body (ppo_loss_body.cuh,
// shared with K4) runs 128 samples at a time through both towers with the
// weights and activations in shared memory, each product a register-tiled
// outer product (8 x 8 tiles: 64 independent FMA chains a thread, 4 float4
// loads per 64 FMAs), and each weight-gradient entry owned by one thread.
// The reduction across CTAs is deterministic: each CTA writes its partial
// sums, and a second launch adds them in block order, one thread per
// entry.
//
// compute_dtype "bfloat16" launches the kBf instances, the same function
// with the operands of every product rounded to bf16 and the exact
// products summed in float32, as the TPU kernel's bf16 mode (its default,
// pallas_ppo.py:381, :429); their twin is the same function with
// compute_dtype="bfloat16".  They run their own body,
// ppo_loss_body_bf16.cuh, whose products are on the tensor cores
// (mma.sync m16n8k16 bf16, 989 TFLOP/s against the FP32 pipes' 67) but
// the first layer's, which runs in the twin's order: 64 samples a
// sub-block, a warp carrying one tower's chain of 16 samples from the obs
// to dpre1 in registers, the weight gradients after one barrier; a sample
// at a decision of the loss takes its head from the twin's order.  What
// bounds them then is no longer the products alone but the tanhf of the
// two layers, the loss and the barriers between the dependent products
// (ppo_loss_body_bf16.cuh).  The reduction across CTAs is the same.

#include <cuda_runtime.h>
#include <stdint.h>

#include "ppo_loss_body.cuh"
#include "ppo_loss_body_bf16.cuh"

namespace {

using namespace reinmav::ppo_loss;

template <int kD, int kA, bool kKl, bool kBf>
__global__ void __launch_bounds__(kThreads, 1)
ppo_loss_kernel(const float* __restrict__ data, int64_t n, const int* __restrict__ perm,
                int64_t mb, int tile, const float* __restrict__ adv_stats,
                const float* __restrict__ net, LossCfg cfg, float* __restrict__ partials) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  if constexpr (kBf) {
    namespace tc = reinmav::ppo_loss_bf16;
    tc::Smem<kD, kA>& sm = *reinterpret_cast<tc::Smem<kD, kA>*>(smem_raw);
    tc::load_weights<kD, kA>(sm, net);
    const float adv_shift = adv_stats[0], adv_inv = adv_stats[1], kl_beta = adv_stats[2];
    __syncthreads();
    tc::loss_body<kD, kA, kKl>(sm, data, n, perm, mb, tile, adv_shift, adv_inv, kl_beta, cfg,
                               partials + static_cast<int64_t>(blockIdx.x) * out_size<kD, kA>());
  } else {
    Smem<kD, kA>& sm = *reinterpret_cast<Smem<kD, kA>*>(smem_raw);
    load_weights<kD, kA, kBf>(sm, net);
    const float adv_shift = adv_stats[0], adv_inv = adv_stats[1], kl_beta = adv_stats[2];
    __syncthreads();
    loss_body<kD, kA, kKl, kBf>(sm, data, n, perm, mb, tile, adv_shift, adv_inv, kl_beta, cfg,
                                partials + static_cast<int64_t>(blockIdx.x) * out_size<kD, kA>());
  }
}

// The bf16 body's forward, sample by sample (clipped mode): each minibatch
// sample's ratio and value from the tensor cores and as the loss takes
// them into probe (4 mb floats), the partial sums as ppo_loss_kernel writes
// them.  A diagnostic beside the main path, which
// never launches it: it counts the samples whose forward, or whose clip
// decision, is not the twin's.
template <int kD, int kA>
__global__ void __launch_bounds__(kThreads, 1)
ppo_loss_probe_kernel(const float* __restrict__ data, int64_t n, const int* __restrict__ perm,
                      int64_t mb, int tile, const float* __restrict__ adv_stats,
                      const float* __restrict__ net, LossCfg cfg, float* __restrict__ partials,
                      float* __restrict__ probe) {
  namespace tc = reinmav::ppo_loss_bf16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  tc::Smem<kD, kA>& sm = *reinterpret_cast<tc::Smem<kD, kA>*>(smem_raw);
  tc::load_weights<kD, kA>(sm, net);
  __syncthreads();
  tc::loss_body<kD, kA, false, true>(sm, data, n, perm, mb, tile, adv_stats[0], adv_stats[1], 0.0f,
                                     cfg, partials + static_cast<int64_t>(blockIdx.x) * out_size<kD, kA>(),
                                     probe);
}

// out[e] = the CTAs' partials of entry e, added in block order.
__global__ void ppo_loss_reduce_kernel(const float* __restrict__ partials, int blocks, int n_out,
                                       float* __restrict__ out) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n_out) return;
  float v = 0.0f;
  for (int b = 0; b < blocks; ++b) v += partials[static_cast<int64_t>(b) * n_out + e];
  out[e] = v;
}

template <int kD, int kA, bool kKl, bool kBf>
cudaError_t launch(const float* data, int64_t n, const int* perm, int64_t mb, int tile,
                   const float* adv_stats, const float* net, const LossCfg& cfg, float* partials,
                   int blocks, cudaStream_t stream) {
  const int smem = static_cast<int>(
      kBf ? sizeof(reinmav::ppo_loss_bf16::Smem<kD, kA>) : sizeof(Smem<kD, kA>));
  cudaError_t err = cudaFuncSetAttribute(ppo_loss_kernel<kD, kA, kKl, kBf>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  ppo_loss_kernel<kD, kA, kKl, kBf><<<blocks, kThreads, smem, stream>>>(
      data, n, perm, mb, tile, adv_stats, net, cfg, partials);
  return cudaGetLastError();
}

template <int kD, int kA>
cudaError_t launch_dims(const float* data, int64_t n, const int* perm, int64_t mb, int tile,
                        const float* adv_stats, const float* net, const LossCfg& cfg,
                        bool kl_mode, bool bf16, float* partials, float* out, int blocks,
                        cudaStream_t stream) {
  auto run = [&](auto kl, auto bf) {
    return launch<kD, kA, decltype(kl)::value, decltype(bf)::value>(
        data, n, perm, mb, tile, adv_stats, net, cfg, partials, blocks, stream);
  };
  using std::integral_constant;
  using T = integral_constant<bool, true>;
  using F = integral_constant<bool, false>;
  cudaError_t err = kl_mode ? (bf16 ? run(T{}, T{}) : run(T{}, F{}))
                            : (bf16 ? run(F{}, T{}) : run(F{}, F{}));
  if (err != cudaSuccess) return err;
  constexpr int n_out = out_size<kD, kA>();
  ppo_loss_reduce_kernel<<<(n_out + 255) / 256, 256, 0, stream>>>(partials, blocks, n_out, out);
  return cudaGetLastError();
}

}  // namespace

// The number of CTAs ppo_loss_launch uses for a minibatch of mb samples:
// one per sub-block of 128, at most one per SM (each takes 215-221 KiB of
// shared memory in float32, 125-128 KiB in bf16; the bf16 body's sub-blocks of
// 64 are twice as many).  The caller sizes the (blocks, NET + 4) partials scratch.
extern "C" int ppo_loss_blocks(long long mb) {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return -1;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) return -1;
  const long long sub = (mb + kS - 1) / kS;
  return static_cast<int>(sub < sms ? sub : sms);
}

// C interface, bound with ctypes (reinmav_tpu_torch/_build.py).  Launches on
// the given stream, does not synchronise, and returns a CUDA error code.
// (d, adim) the obs and action dims, a pair of with_kernel_dims (any other
// is refused with cudaErrorInvalidValue and nothing runs); data (d + adim +
// 4, n) f32; perm (m,) int32 tile indices;
// adv_stats (4,) f32 = [adv shift, adv inverse scale, kl beta, 0] on the
// device; net the flat parameters; out (NET + 4,) raw sums; bf16 nonzero
// launches the bf16 instance.
extern "C" int ppo_loss_launch(int d, int adim, const void* data, long long n, const void* perm,
                               long long m, int tile, const void* adv_stats, const void* net,
                               float clip_eps, float value_clip_eps, float value_coef,
                               int kl_mode, int bf16, int blocks, void* partials, void* out,
                               void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  const LossCfg cfg{clip_eps, value_clip_eps, value_coef};
  const long long mb = m * tile;
  const auto* x = static_cast<const float*>(data);
  const auto* p = static_cast<const int*>(perm);
  const auto* a = static_cast<const float*>(adv_stats);
  const auto* w = static_cast<const float*>(net);
  auto* part = static_cast<float*>(partials);
  auto* o = static_cast<float*>(out);
  const cudaError_t err =
      with_kernel_dims(d, adim, cudaErrorInvalidValue, [&](auto dc, auto ac_) {
        return launch_dims<decltype(dc)::value, decltype(ac_)::value>(
            x, n, p, mb, tile, a, w, cfg, kl_mode, bf16 != 0, part, o, blocks, st);
      });
  return static_cast<int>(err);
}

// The bf16 body's forward probe (ppo_loss_probe_kernel): ppo_loss_launch's
// arguments in the clipped mode, probe (m tile, 4) f32 out.
extern "C" int ppo_loss_probe_launch(int d, int adim, const void* data, long long n,
                                     const void* perm, long long m, int tile,
                                     const void* adv_stats, const void* net, float clip_eps,
                                     float value_clip_eps, float value_coef, int blocks,
                                     void* partials, void* probe, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  const LossCfg cfg{clip_eps, value_clip_eps, value_coef};
  const cudaError_t err =
      with_kernel_dims(d, adim, cudaErrorInvalidValue, [&](auto dc, auto ac_) {
        constexpr int kD = decltype(dc)::value, kA = decltype(ac_)::value;
        const int smem = static_cast<int>(sizeof(reinmav::ppo_loss_bf16::Smem<kD, kA>));
        cudaError_t e = cudaFuncSetAttribute(ppo_loss_probe_kernel<kD, kA>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (e != cudaSuccess) return e;
        ppo_loss_probe_kernel<kD, kA><<<blocks, kThreads, smem, st>>>(
            static_cast<const float*>(data), n, static_cast<const int*>(perm), m * tile, tile,
            static_cast<const float*>(adv_stats), static_cast<const float*>(net), cfg,
            static_cast<float*>(partials), static_cast<float*>(probe));
        return cudaGetLastError();
      });
  return static_cast<int>(err);
}

// The length of the kernel's output for obs and action dims (d, adim): the
// flat parameters' gradient sums, then the 4 metric sums; -1 for dims it is
// not built for.
extern "C" int ppo_loss_out_size(int d, int adim) {
  return with_kernel_dims(d, adim, -1, [](auto dc, auto ac_) {
    return out_size<decltype(dc)::value, decltype(ac_)::value>();
  });
}
