// The bf16 instances of K7 and their probe (offpolicy_collect_bf16.cuh),
// built apart from offpolicy_collect.cu's float32 instances; its entry
// points launch them through reinmav::offpolicy_bf16::launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include "env_kinds.cuh"
#include "offpolicy_collect_bf16.cuh"

namespace {

namespace ob = reinmav::offpolicy_bf16;

template <class Env, int kMode, bool kProbe>
__global__ void __launch_bounds__(ob::kThreads, 1)
offpolicy_collect_bf16_kernel(const float* __restrict__ s_in, int64_t batch, ob::Widths wd,
                              ob::Actor w, const float* __restrict__ consts, uint32_t seed,
                              typename Env::Params p, float* __restrict__ s_out,
                              float* __restrict__ block, unsigned* __restrict__ probe) {
  ob::collect<Env, kMode, kProbe>(s_in, batch, wd, w, consts, seed, p, s_out, block, probe);
}

// Persistent CTAs, one an SM (or one a tile where there are fewer).
template <class Env, int kMode, bool kProbe>
cudaError_t launch_mode(const float* s_in, int64_t batch, const ob::Widths& wd, const ob::Actor& w,
                        const float* consts, uint32_t seed, const float* params_host,
                        float* s_out, float* block, unsigned* probe, cudaStream_t st) {
  constexpr int kOut = (kMode == ob::kSac || kMode == ob::kSacDet) ? 2 * Env::kA : Env::kA;
  const int bytes = ob::smem_layout(wd, kOut).bytes;
  int device = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return e;
  const int64_t tiles = (batch + ob::kTile - 1) / ob::kTile;
  const auto blocks = static_cast<unsigned int>(tiles < sms ? tiles : sms);
  auto kernel = offpolicy_collect_bf16_kernel<Env, kMode, kProbe>;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return e;
  kernel<<<blocks, ob::kThreads, bytes, st>>>(s_in, batch, wd, w, consts, seed,
                                               Env::params(params_host), s_out, block, probe);
  return cudaGetLastError();
}

}  // namespace

cudaError_t reinmav::offpolicy_bf16::launch(int env_kind, int mode, const float* params_host,
                                            const float* s_in, int64_t batch, int hidden1,
                                            int hidden2, const Actor& w, const float* consts,
                                            uint32_t seed, float* s_out, float* block,
                                            unsigned* probe, cudaStream_t st) {
  const Widths wd = widths(hidden1, hidden2);
  return reinmav::with_env_kind(env_kind, [&](auto env) {
    using Env = decltype(env);
    if (probe != nullptr) {  // the probe: modes sac and td3
      if (mode == kSac) {
        return launch_mode<Env, kSac, true>(s_in, batch, wd, w, consts, seed, params_host, s_out,
                                            block, probe, st);
      }
      if (mode == kTd3) {
        return launch_mode<Env, kTd3, true>(s_in, batch, wd, w, consts, seed, params_host, s_out,
                                            block, probe, st);
      }
      return cudaErrorInvalidValue;
    }
    switch (mode) {
      case kSac:
        return launch_mode<Env, kSac, false>(s_in, batch, wd, w, consts, seed, params_host, s_out,
                                             block, nullptr, st);
      case kSacDet:
        return launch_mode<Env, kSacDet, false>(s_in, batch, wd, w, consts, seed, params_host,
                                                s_out, block, nullptr, st);
      case kTd3:
        return launch_mode<Env, kTd3, false>(s_in, batch, wd, w, consts, seed, params_host, s_out,
                                             block, nullptr, st);
      case kTd3Det:
        return launch_mode<Env, kTd3Det, false>(s_in, batch, wd, w, consts, seed, params_host,
                                                s_out, block, nullptr, st);
      default:
        return cudaErrorInvalidValue;
    }
  });
}
