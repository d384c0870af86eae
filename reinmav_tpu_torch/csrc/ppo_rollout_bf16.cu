// The bf16 instances of K2/K6 and their probe (ppo_rollout_body_bf16.cuh),
// built apart from ppo_rollout.cu's float32 instances; ppo_rollout.cu's
// entry points launch them through reinmav::ppo_rollout_bf16::launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include "env_kinds.cuh"
#include "ppo_rollout_body_bf16.cuh"

namespace {

namespace rb = reinmav::ppo_rollout_bf16;

template <class Env, bool kNormObs, bool kNormRew, bool kProbe>
__global__ void __launch_bounds__(rb::kThreads, 2)
ppo_rollout_bf16_kernel(const float* __restrict__ s_in, const float* __restrict__ ret_in,
                        const float* __restrict__ net, const float* __restrict__ consts,
                        int64_t batch, int horizon, uint32_t seed, uint32_t env_base,
                        typename Env::Params p, rb::Out o, unsigned* __restrict__ probe) {
  rb::rollout<Env, kNormObs, kNormRew, kProbe>(s_in, ret_in, net, consts, batch, horizon, seed,
                                                env_base, p, o, probe);
}

template <class Env, bool kNormObs, bool kNormRew, bool kProbe>
cudaError_t launch_instance(const float* s_in, const float* ret_in, const float* net,
                            const float* consts, int64_t batch, int horizon, uint32_t seed,
                            uint32_t env_base, const typename Env::Params& p, const rb::Out& o,
                            unsigned* probe, cudaStream_t st) {
  constexpr int kSmem = sizeof(rb::Smem<Env::kD, Env::kA>);
  auto kernel = ppo_rollout_bf16_kernel<Env, kNormObs, kNormRew, kProbe>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return err;
  const auto blocks = static_cast<unsigned int>((batch + rb::kCtaEnvs - 1) / rb::kCtaEnvs);
  kernel<<<blocks, rb::kThreads, kSmem, st>>>(s_in, ret_in, net, consts, batch, horizon, seed,
                                               env_base, p, o, probe);
  return cudaGetLastError();
}

}  // namespace

cudaError_t reinmav::ppo_rollout_bf16::launch(int env_kind, bool norm_obs, bool norm_rew,
                                              const float* s_in, const float* ret_in,
                                              const float* net, const float* consts,
                                              int64_t batch, int horizon, uint32_t seed,
                                              uint32_t env_base, const float* params_host,
                                              const Out& o, unsigned* probe, cudaStream_t st) {
  return reinmav::with_env_kind(env_kind, [&](auto env) {
    using Env = decltype(env);
    const typename Env::Params p = Env::params(params_host);
    if (probe != nullptr) {  // the probe: both normalisers on
      if (!(norm_obs && norm_rew)) return cudaErrorInvalidValue;
      return launch_instance<Env, true, true, true>(s_in, ret_in, net, consts, batch, horizon,
                                                    seed, env_base, p, o, probe, st);
    }
    if (norm_obs && norm_rew) {
      return launch_instance<Env, true, true, false>(s_in, ret_in, net, consts, batch, horizon,
                                                     seed, env_base, p, o, nullptr, st);
    } else if (norm_obs) {
      return launch_instance<Env, true, false, false>(s_in, ret_in, net, consts, batch, horizon,
                                                      seed, env_base, p, o, nullptr, st);
    } else if (norm_rew) {
      return launch_instance<Env, false, true, false>(s_in, ret_in, net, consts, batch, horizon,
                                                      seed, env_base, p, o, nullptr, st);
    }
    return launch_instance<Env, false, false, false>(s_in, ret_in, net, consts, batch, horizon,
                                                     seed, env_base, p, o, nullptr, st);
  });
}
