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
// What bounds it: the products, about 2 (6 H^2 + 4 D H + 3 H (A + 1))
// operations a sample (8.1e5 at H = 256, D = 10), on the tensor cores:
// float32 as 3xTF32 (three tf32 products for each, so 495 / 3 TFLOP/s),
// bf16 at 989 TFLOP/s; and the 4 H tanhf a sample on the SFUs.  The design
// (ppo_loss_body_wide.cuh): the weights packed into mma fragments by a
// first launch (ppo_wide_pack_kernel); one CTA of 512 threads an SM, half
// of the CTAs on each tower, each over its sub-blocks of 64 samples (phase
// A: forward, loss, dpre on the tensor cores, the weight gradient's
// operands to the CTA's panels in global memory), then the CTA's dW1 and
// dW2 over all its samples in registers (phase B), written once to its row
// of partial sums.
// A last launch adds, for each entry, the rows of its tower's CTAs in block
// order, one thread an entry, so a rerun is bitwise equal.
//
// compute_dtype "bfloat16" launches the kBf instances: bf16 products
// (mma.sync m16n8k16) summed in float32, the h's near a bf16 midpoint
// recomputed in the twin's order.

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
  const uint4* packed;     // both towers' packed weights (ppo_wide_pack_kernel)
  uint4* panels;           // (gridDim.x, groups, Shape::group) scratch
  int groups;              // groups_per_cta
  float* partials;         // (gridDim.x, NET + 4)
  unsigned long long* rec_counts;  // [h1, h2] recomputed, or null
  int d, adim, h;
  LossCfg cfg;
};

template <bool kKl, bool kBf>
__global__ void __launch_bounds__(kThreads, 1) ppo_loss_wide_kernel(WideArgs a) {
  extern __shared__ __align__(16) float smem[];
  const Shape sh = make_shape(a.d, a.adim, a.h, kBf);
  const reinmav::ac::RtLayout L(a.d, a.adim, a.h);
  load_small<kBf>(smem, sh, L, a.net, blockIdx.x & 1);
  const float adv_shift = a.adv_stats[0], adv_inv = a.adv_stats[1], kl_beta = a.adv_stats[2];
  __syncthreads();
  loss_body<kKl, kBf>(smem, sh, L, a.packed, a.data, a.n, a.perm, a.mb, a.tile, adv_shift,
                      adv_inv, kl_beta, a.cfg,
                      a.panels + static_cast<int64_t>(blockIdx.x) * a.groups * sh.group,
                      a.partials + static_cast<int64_t>(blockIdx.x) * (L.net_size + 4),
                      a.rec_counts);
}

// The weights of `net` into the packed layout (pack_entry), one thread an
// entry; `packed` zeroed by the caller.
template <bool kBf>
__global__ void ppo_wide_pack_kernel(int d, int adim, int h, const float* __restrict__ net,
                                     uint32_t* __restrict__ packed) {
  const Shape sh = make_shape(d, adim, h, kBf);
  const reinmav::ac::RtLayout L(d, adim, h);
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < L.net_size; e += gridDim.x * blockDim.x) {
    pack_entry<kBf>(sh, L, packed, e, net[e]);
  }
}

// out[e] = the partials of entry e of the CTAs of its tower (owner_tower),
// added in block order.
__global__ void ppo_wide_reduce_kernel(const float* __restrict__ partials, int blocks, int d,
                                       int adim, int h, float* __restrict__ out) {
  const reinmav::ac::RtLayout L(d, adim, h);
  const int n_out = L.net_size + 4;
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n_out) return;
  float v = 0.0f;
  for (int b = owner_tower(L, e); b < blocks; b += 2) {
    v += partials[static_cast<int64_t>(b) * n_out + e];
  }
  out[e] = v;
}

template <bool kKl, bool kBf>
cudaError_t launch(const WideArgs& a, int blocks, cudaStream_t stream) {
  const int smem = smem_bytes(make_shape(a.d, a.adim, a.h, kBf));
  cudaError_t err = cudaFuncSetAttribute(ppo_loss_wide_kernel<kKl, kBf>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  ppo_loss_wide_kernel<kKl, kBf><<<blocks, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// The number of CTAs the wide K3 and K4 launch for a minibatch of mb
// samples: two a sub-block of 64 (one a tower), at most one an SM, an even
// number (grid_blocks).  -1 on a CUDA error.
extern "C" int ppo_loss_wide_blocks(long long mb) {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return -1;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) return -1;
  return grid_blocks(mb, sms);
}

// The sums ppo_loss_wide_launch writes for widths (d, adim, h): the flat
// gradient, then the 4 metrics; -1 for widths the wide body does not take.
extern "C" int ppo_loss_wide_out_size(int d, int adim, int h) {
  return takes(d, adim, h) ? reinmav::ac::RtLayout(d, adim, h).net_size + 4 : -1;
}

// The body's plan at (d, adim, h), dtype bf16, a minibatch of mb samples
// and `blocks` CTAs into out[8]: samples a sub-block, shared memory bytes,
// panel groups a CTA, 16-byte words a group, 16-byte words of the packed
// weights (both towers), the row stride of its [unit][sample] arrays, the
// units padded, the obs rows padded.  0, or -1 for widths it does not take
// or a grid it cannot run.
extern "C" int ppo_wide_plan(int d, int adim, int h, int bf16, long long mb, int blocks,
                             long long* out) {
  if (!takes(d, adim, h) || blocks < 2 || blocks % 2 || mb < 1) return -1;
  const Shape sh = make_shape(d, adim, h, bf16 != 0);
  const long long v[8] = {kS, smem_bytes(sh), groups_per_cta(mb, blocks), sh.group,
                          2LL * sh.planes * sh.packed, sh.SP, sh.Hp, sh.Dp};
  for (int i = 0; i < 8; ++i) out[i] = v[i];
  return 0;
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

// The weights of net into `packed` (zeroed by the caller; plan[4] 16-byte
// words) in the layout of the instance of dtype bf16.  C interface, bound
// with ctypes; launches on the given stream; a CUDA error code.
extern "C" int ppo_wide_pack_launch(int d, int adim, int h, int bf16, const void* net,
                                    void* packed, void* stream) {
  if (!takes(d, adim, h)) return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  const int n = reinmav::ac::RtLayout(d, adim, h).net_size;
  const int grid = (n + 255) / 256;
  if (bf16) {
    ppo_wide_pack_kernel<true><<<grid, 256, 0, st>>>(d, adim, h, static_cast<const float*>(net),
                                                     static_cast<uint32_t*>(packed));
  } else {
    ppo_wide_pack_kernel<false><<<grid, 256, 0, st>>>(d, adim, h, static_cast<const float*>(net),
                                                      static_cast<uint32_t*>(packed));
  }
  return static_cast<int>(cudaGetLastError());
}

// C interface, bound with ctypes (reinmav_tpu_torch/_build.py).  Launches on
// the given stream, does not synchronise, and returns a CUDA error code
// (cudaErrorInvalidValue, nothing run, for widths the wide body does not
// take or a plan that is not its own: ppo_wide_plan).  data (d + adim + 4,
// n) f32; perm (m,) int32 tile indices; adv_stats (4,) f32 [adv shift, adv
// inverse scale, kl beta, 0]; net the flat parameters at hidden width h;
// plan (5,) int64 on the host; partials (blocks, NET + 4) scratch; packed
// (plan[4] 16-byte words, zeroed) and panels (blocks x plan[2] x plan[3]
// 16-byte words) scratch; rec_counts (2,) uint64 [h1, h2 recomputed] added
// to in the bf16 instance, or null; out (NET + 4,) raw sums; bf16 nonzero
// launches the bf16 instance.  Three launches: pack, the body, the sums.
extern "C" int ppo_loss_wide_launch(int d, int adim, int h, const void* data, long long n,
                                    const void* perm, long long m, int tile,
                                    const void* adv_stats, const void* net, float clip_eps,
                                    float value_clip_eps, float value_coef, int kl_mode, int bf16,
                                    int blocks, const void* plan, void* partials, void* packed,
                                    void* panels, void* rec_counts, void* out, void* stream) {
  const long long* pl = static_cast<const long long*>(plan);
  if (!plan_ok(d, adim, h, bf16 != 0, m * tile, blocks, pl)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err = static_cast<cudaError_t>(ppo_wide_pack_launch(d, adim, h, bf16, net, packed,
                                                                  stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  WideArgs a{};
  a.data = static_cast<const float*>(data);
  a.n = n;
  a.perm = static_cast<const int*>(perm);
  a.mb = m * tile;
  a.tile = tile;
  a.adv_stats = static_cast<const float*>(adv_stats);
  a.net = static_cast<const float*>(net);
  a.packed = static_cast<const uint4*>(packed);
  a.panels = static_cast<uint4*>(panels);
  a.groups = static_cast<int>(pl[2]);
  a.partials = static_cast<float*>(partials);
  a.rec_counts = static_cast<unsigned long long*>(rec_counts);
  a.d = d;
  a.adim = adim;
  a.h = h;
  a.cfg = LossCfg{clip_eps, value_clip_eps, value_coef, log_norm(adim)};
  err = kl_mode ? (bf16 ? launch<true, true>(a, blocks, st) : launch<true, false>(a, blocks, st))
                : (bf16 ? launch<false, true>(a, blocks, st) : launch<false, false>(a, blocks, st));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_out = reinmav::ac::RtLayout(d, adim, h).net_size + 4;
  ppo_wide_reduce_kernel<<<(n_out + 255) / 256, 256, 0, st>>>(
      static_cast<const float*>(partials), blocks, d, adim, h, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
