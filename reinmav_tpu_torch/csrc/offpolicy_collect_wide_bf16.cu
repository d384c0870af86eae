// K7 wide bf16 (compute_dtype "bfloat16"): the fused off-policy collection
// step of offpolicy_collect_wide.cu with the actor's two hidden layers on
// the tensor cores (mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32,
// mma_bf16.cuh), for hidden layers each from 1 to 1024 units wide (the
// narrow bf16 instance, offpolicy_collect_bf16.cuh, takes each from 1 to
// 256).  The same function as the TPU kernel's bf16 mode (reinmav_tpu/ops/
// pallas_offpolicy.py::collect_step_pallas :155, its products :97-101 with
// cd bf16 :186) at any width: every operand of a product rounded to bf16,
// the exact products summed in float32.  Its plain twin is ops/
// offpolicy.py::collect_step_reference with compute_dtype "bfloat16"
// (_actor_bf16).
//
// What bounds it: the products, 2 (D H1 + H1 H2 + H2 OUT) an env, at 989
// TFLOP/s: 0.017 ms at TD3's (10, 400, 300, 4), 0.036 at SAC's (13, 512,
// 512, 8), 0.142 at (13, 1024, 1024, 8), for 65,536 envs; about 232 B an
// env of states and block.
//
// Design.  The narrow instance keeps W2 whole in shared memory as bf16:
// 262 KB at (400, 300) with its padding, 2 MB at 1024, against a CTA's 227
// KB.  Here a persistent CTA of 8 MLP warps and 2 env warps (one an SM)
// walks tiles of 64 envs, as the narrow instance, and keeps the tile's bf16
// h1 rows (64 x (H1 rounded up to 128, + 8): 132 KB at 1024) and one
// 128-column pass of its h2 rows; W2 streams through a ring of four slots of
// 64 k-rows x 128 columns (cp.async, 16 B a copy), B fragments by
// ldmatrix.trans from the slot.  A pack kernel of its own
// (offpolicy_wide_pack_kernel, launched by the wrapper before the body on the
// same stream: two launches a collection) writes the weights into the caller's
// scratch in the layouts the body reads (Bf16Pack): W2 in bf16 padded to the
// ring's slots, W2 transposed (each unit's column contiguous, for the recompute
// in the twin's order), W1 transposed (layer 1's B fragments are two 32-bit
// loads a lane, from global memory through the L1), W3 rounded to bf16 and the
// biases, all zero past the widths.  MLP warp w takes rows 16 (w % 4) .. + 15
// of the tile and columns 64 (w / 4) .. + 63 of each 128-column pass:
//   L1  h1 = relu(x W1 + b1)   one k16 step (D padded to 16) a pass
//   L2  h2 = relu(h1 W2 + b2)  k2 / 16 steps a pass, h1's A fragments by
//       ldmatrix from the tile's rows
// each layer's outputs rounded to bf16 once, when stored.  After each L2
// pass the head (OUT <= 8 columns, FP32 FMAs on the bf16 h2) folds the
// pass's four chunks of 32 units into each thread's running sums in the
// twin's chunk fold (_actor_bf16, as the narrow instance: MLP thread t takes
// env t % 64 and columns t / 64 and t / 64 + 4), the chunks in order from
// 0, then the bias: given the twin's bf16 h2 the head is the twin's bit for
// bit.
//
// Numerics, as the narrow instance: a pre-activation within tie(v) of a bf16
// midpoint or of 0 is recomputed in the twin's order (from 0 over the layer's
// inputs in order, then the bias; the warp's flagged units one a lane,
// tc::for_each_flagged).  Layer 1's window is the narrow instance's (2^-19 +
// 2^-18 |v|, its chain at most 16 products); layer 2's is that times
// l2_tie_scale(H1) (offpolicy_collect_wide.cuh): the tensor cores' sum drifts
// further from a longer FMA chain.  The probe instance (kProbe,
// offpolicy_collect_wide_bf16_probe_launch, on no training path) recomputes
// every unit and counts the units recomputed, the misses and the largest |sum -
// twin's| / tie(twin's) of each layer.  No atomics on the main path: a rerun is
// bitwise equal.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "env_kinds.cuh"
#include "mma_bf16.cuh"
#include "offpolicy_collect_wide.cuh"

namespace {

namespace ow = reinmav::offpolicy_wide;
namespace tc = reinmav::tc;
using ow::Actor;
using ow::bar_arrive;
using ow::bar_sync;
using ow::Bf16Pack;
using ow::Bf16Plan;
using ow::Bf16Smem;
using ow::kBarFree;
using ow::kBarMlp;
using ow::kBarReady;
using ow::kBfCols;
using ow::kBfRows;
using ow::kBfSlots;
using ow::kColStride;
using ow::kXP;
using tc::bf16;

constexpr int kMlp = 256;        // threads of the MLP warps (8)
constexpr int kEnvThreads = 64;  // threads of the env warps (2), one an env
constexpr int kThreads = kMlp + kEnvThreads;
constexpr int kTile = ow::kBfTile;  // envs a tile: 4 m16 row blocks
// The narrow bf16 instance's window (offpolicy_collect_bf16.cuh).
constexpr float kTieAbs = 1.0f / (1 << 19);
constexpr float kTieRel = 1.0f / (1 << 18);

__device__ __forceinline__ float tie(float v, float scale) {
  return scale * (kTieAbs + fabsf(v) * kTieRel);
}

// Whether a pre-activation v lies near enough to 0 or to a bf16 midpoint
// that another order of summation could change relu(v)'s bf16 (bitwise
// operators: no branch a value).
__device__ __forceinline__ bool near_edge(float v, float scale) {
  return (fabsf(v) <= scale * kTieAbs) | ((v > 0.0f) & (tc::midpoint_distance(v) <= tie(v, scale)));
}

// A 16-byte asynchronous copy to shared memory, not cached in L1.
__device__ __forceinline__ void copy16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(tc::smem_addr(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void copy_wait_ring() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kBfSlots - 2) : "memory");
}

// Ring slot t of the tile's L2 (pass t / slots_a_pass, k-rows 64 (t %
// slots_a_pass) ..) from the packed W2 (k2, n2p): thread tid copies the
// 16-byte pieces tid + kMlp n of the slot's 64 rows x 128 columns.
__device__ __forceinline__ void copy_slot(bf16* slot, const bf16* __restrict__ w2, int t,
                                          int slots_a_pass, const Bf16Plan& pl, int tid) {
  const int pass = t / slots_a_pass, k0 = kBfRows * (t - pass * slots_a_pass);
#pragma unroll
  for (int n = 0; n < kBfRows * kBfCols / 8 / kMlp; ++n) {
    const int i = tid + n * kMlp, r = i >> 4, c8 = 8 * (i & 15);
    copy16(slot + r * kColStride + c8, w2 + static_cast<int64_t>(k0 + r) * pl.n2p +
                                           kBfCols * pass + c8);
  }
}

// A layer's epilogue for the warp's block (rows r0 .. r0 + 15, 8 n8 tiles
// from column col (of the layer; col_rows of `rows`), accumulators c[nt]):
// the bias added (c keeps the pre-activations), relu(pre) rounded to bf16
// and stored to `rows`; returns the slots (4 nt + i) near an edge, past the
// layer's width `width` none.
__device__ __forceinline__ uint32_t relu_store(float (&c)[8][4], const float* __restrict__ bias,
                                               int width, bf16* rows, int stride, int r0, int col,
                                               int col_rows, float scale, int lane) {
  const int g = lane >> 2, q = lane & 3;
  uint32_t near = 0;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int cc = col + 8 * nt + 2 * q, cr = col_rows + 8 * nt + 2 * q;
    const float2 b = *reinterpret_cast<const float2*>(bias + cc);
    float v[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      c[nt][i] += i & 1 ? b.y : b.x;
      v[i] = fmaxf(c[nt][i], 0.0f);
      const bool edge = (cc + (i & 1) < width) & near_edge(c[nt][i], scale);
      near |= static_cast<uint32_t>(edge) << (4 * nt + i);
    }
    tc::st_pair(rows + (r0 + g) * stride + cr, tc::pack(v[0], v[1]));
    tc::st_pair(rows + (r0 + g + 8) * stride + cr, tc::pack(v[2], v[3]));
  }
  return near;
}

// The units of the warp's flagged slots recomputed by unit(row, column of
// the layer), the bias added, and relu of that stored, rounded to bf16,
// into `rows`, one a lane a pass (tc::for_each_flagged; `list` the warp's
// 32 words).
template <class Unit>
__device__ __forceinline__ void fix_edges(uint32_t near, const float* __restrict__ bias,
                                          bf16* rows, int stride, int r0, int col, int col_rows,
                                          uint32_t* list, int lane, Unit&& unit) {
  tc::for_each_flagged(near, list, lane, [&](int owner, int slot) {
    const int row = r0 + tc::acc_row(owner, slot & 3);
    const int dc = 8 * (slot >> 2) + tc::acc_col(owner, slot & 3);
    rows[row * stride + col_rows + dc] =
        __float2bfloat16_rn(fmaxf(unit(row, col + dc) + bias[col + dc], 0.0f));
  });
}

// The probe's check of one layer's block: every unit of a valid row and
// column recomputed in the twin's order, the misses counted, the largest
// |pre - twin's| / tie(twin's) kept.
template <class Unit>
__device__ __forceinline__ void probe_layer(const float (&c)[8][4], uint32_t near,
                                            const float* __restrict__ bias, int width,
                                            int valid_rows, int r0, int col, float scale,
                                            int lane, Unit&& unit, unsigned& redone,
                                            unsigned& missed, float& worst) {
#pragma unroll 1  // one copy of unit's code: the probe's build time, not its speed
  for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = r0 + tc::acc_row(lane, i), cc = col + 8 * nt + tc::acc_col(lane, i);
      if (row >= valid_rows || cc >= width) continue;
      const float twin = unit(row, cc) + bias[cc];
      worst = fmaxf(worst, fabsf(c[nt][i] - twin) / tie(twin, scale));
      const bool fixed = (near >> (4 * nt + i)) & 1u;
      redone += fixed;
      missed += !fixed && tc::round_bf16(fmaxf(twin, 0.0f)) != tc::round_bf16(fmaxf(c[nt][i], 0.0f));
    }
  }
}

// The head of the twin's chunk fold on one chunk of 32 units (the narrow
// instance's): h the bf16 h2 units as float32, w the column's weights.
__device__ __forceinline__ float chunk_fold(const float (&h)[32], const float* __restrict__ w) {
  float run[8];
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const float4 wv = __ldg(reinterpret_cast<const float4*>(w + 4 * r));
    float s = fmaf(h[4 * r], wv.x, 0.0f);
    s = fmaf(h[4 * r + 1], wv.y, s);
    s = fmaf(h[4 * r + 2], wv.z, s);
    run[r] = fmaf(h[4 * r + 3], wv.w, s);
  }
  const float v0 = run[0] + run[4], v1 = run[1] + run[5], v2 = run[2] + run[6],
              v3 = run[3] + run[7];
  return (v0 + v2) + (v1 + v3);
}

// The pack: W2 into `w2` (k2, n2p) and `w2t` (n2p, k2) bf16 through 32 x
// 32 tiles of shared memory (both written in order), then W1 transposed,
// W3 rounded and the biases, zero past the widths (Bf16Pack).
__global__ void __launch_bounds__(256)
offpolicy_wide_pack_kernel(Actor w, int d, int out, Bf16Plan pl, unsigned char* scratch) {
  const Bf16Pack k = ow::bf16_pack(pl, out);
  auto* w1t = reinterpret_cast<bf16*>(scratch + k.w1t);
  auto* w2 = reinterpret_cast<bf16*>(scratch + k.w2);
  auto* w2t = reinterpret_cast<bf16*>(scratch + k.w2t);
  auto* w3 = reinterpret_cast<float*>(scratch + k.w3);
  auto* b1 = reinterpret_cast<float*>(scratch + k.b1);
  auto* b2 = reinterpret_cast<float*>(scratch + k.b2);
  __shared__ float tile[32][33];
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const int tiles_u = pl.n2p / 32, tiles = (pl.k2 / 32) * tiles_u;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int j0 = 32 * (t / tiles_u), u0 = 32 * (t % tiles_u);
    for (int r = ty; r < 32; r += 8) {
      const int j = j0 + r, u = u0 + tx;
      const float v = j < pl.h1 && u < pl.h2 ? w.w2[static_cast<int64_t>(j) * pl.h2 + u] : 0.0f;
      tile[r][tx] = v;
      w2[static_cast<int64_t>(j) * pl.n2p + u] = __float2bfloat16_rn(v);
    }
    __syncthreads();
    for (int r = ty; r < 32; r += 8) {
      w2t[static_cast<int64_t>(u0 + r) * pl.k2 + j0 + tx] = __float2bfloat16_rn(tile[tx][r]);
    }
    __syncthreads();
  }
  const int stride = gridDim.x * blockDim.x;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < pl.k1p * 16; i += stride) {
    const int u = i / 16, dd = i % 16;
    w1t[i] = __float2bfloat16_rn(u < pl.h1 && dd < d ? w.w1[dd * pl.h1 + u] : 0.0f);
  }
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < out * pl.n2p; i += stride) {
    const int o = i / pl.n2p, u = i % pl.n2p;
    w3[i] = u < pl.h2 ? tc::round_bf16(w.w3[u * out + o]) : 0.0f;
  }
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < pl.k1p; i += stride) {
    b1[i] = i < pl.h1 ? w.b1[i] : 0.0f;
  }
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < pl.n2p; i += stride) {
    b2[i] = i < pl.h2 ? w.b2[i] : 0.0f;
  }
}

template <class Env, int kMode, bool kProbe>
__global__ void __launch_bounds__(kThreads, 1)
offpolicy_collect_wide_bf16_kernel(const float* __restrict__ s_in, int64_t batch, Bf16Plan pl,
                                   const unsigned char* __restrict__ packed,
                                   const float* __restrict__ b3, const float* __restrict__ consts,
                                   uint32_t seed, typename Env::Params p,
                                   float* __restrict__ s_out, float* __restrict__ block,
                                   unsigned* __restrict__ probe) {
  constexpr int kD = Env::kD;
  constexpr bool kIsSac = kMode == ow::kSac || kMode == ow::kSacDet;
  constexpr int kOut = kIsSac ? 2 * Env::kA : Env::kA;
  static_assert(kD <= 16 && kOut <= 8, "L1 takes one k16 step, the head at most 8 columns");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Bf16Smem m = ow::bf16_smem(pl, kOut);
  bf16* h1s = reinterpret_cast<bf16*>(smem_raw + m.h1);
  bf16* ring = reinterpret_cast<bf16*>(smem_raw + m.ring);
  bf16* h2s = reinterpret_cast<bf16*>(smem_raw + m.h2);
  bf16* xs = reinterpret_cast<bf16*>(smem_raw + m.x);
  float* outs = reinterpret_cast<float*>(smem_raw + m.outs);
  uint32_t* fix = reinterpret_cast<uint32_t*>(smem_raw + m.fix);
  const Bf16Pack k = ow::bf16_pack(pl, kOut);
  const bf16* w1t = reinterpret_cast<const bf16*>(packed + k.w1t);
  const bf16* w2 = reinterpret_cast<const bf16*>(packed + k.w2);
  const bf16* w2t = reinterpret_cast<const bf16*>(packed + k.w2t);
  const float* w3 = reinterpret_cast<const float*>(packed + k.w3);
  const float* b1 = reinterpret_cast<const float*>(packed + k.b1);
  const float* b2 = reinterpret_cast<const float*>(packed + k.b2);

  const int tid = threadIdx.x;
  const int64_t n_env_tiles = (batch + kTile - 1) / kTile;
  const int count = blockIdx.x < n_env_tiles
                        ? static_cast<int>((n_env_tiles - 1 - blockIdx.x) / gridDim.x) + 1
                        : 0;

  if (tid < kMlp) {
    const int lane = tid & 31, warp = tid >> 5;
    const int r0 = 16 * (warp & 3), ch = kBfCols / 2 * (warp >> 2);  // rows, column half
    const int slots_a_pass = pl.k2 / kBfRows, n_slots = (pl.n2p / kBfCols) * slots_a_pass;
    const float tie2 = ow::l2_tie_scale(pl.h1);
    unsigned redone1 = 0, redone2 = 0, missed1 = 0, missed2 = 0;
    float worst1 = 0.0f, worst2 = 0.0f;
    for (int n = 0; n < count; ++n) {
      const int buf = n & 1;
      const int64_t e0 = (blockIdx.x + static_cast<int64_t>(n) * gridDim.x) * kTile;
      const int valid_rows = batch - e0 < kTile ? static_cast<int>(batch - e0) : kTile;
      // The ring's first slots in flight (the last tile's readers are past
      // its h2-complete barrier), then the tile's states as bf16 rows, zero
      // past D and past the batch.
#pragma unroll
      for (int t = 0; t < kBfSlots - 1; ++t) {
        if (t < n_slots) copy_slot(ring + t * kBfRows * kColStride, w2, t, slots_a_pass, pl, tid);
        ow::copy_commit();
      }
      for (int i = tid; i < kTile * 16; i += kMlp) {
        const int e = i & (kTile - 1), d = i / kTile;
        const float v = d < kD && e < valid_rows ? s_in[d * batch + e0 + e] : 0.0f;
        xs[e * kXP + d] = __float2bfloat16_rn(v);
      }
      bar_sync(kBarMlp, kMlp);  // the states; the last tile's rows are read

      float c[8][4];
      // L1 = x W1 a 128-column pass at a time, then the bias and the ReLU.
      auto l1_unit = [&](int row, int col) {
        float z = 0.0f;
#pragma unroll
        for (int d = 0; d < kD; ++d) {
          z = fmaf(tc::to_float(xs[row * kXP + d]), tc::to_float(w1t[col * 16 + d]), z);
        }
        return z;
      };
      {
        uint32_t xa[4];
        tc::ldsm4(xa, xs + (r0 + tc::row_a(lane)) * kXP + tc::col_a(lane));
        for (int col = ch; col < pl.k1p; col += kBfCols) {
#pragma unroll
          for (int nt = 0; nt < 8; ++nt) {
            const bf16* wc = w1t + (col + 8 * nt + (lane >> 2)) * 16 + 2 * (lane & 3);
            const uint32_t b0 = __ldg(reinterpret_cast<const unsigned*>(wc));
            const uint32_t b1v = __ldg(reinterpret_cast<const unsigned*>(wc + 8));
#pragma unroll
            for (int i = 0; i < 4; ++i) c[nt][i] = 0.0f;
            tc::mma(c[nt], xa, b0, b1v);
          }
          const uint32_t near =
              relu_store(c, b1, pl.h1, h1s, pl.s1, r0, col, col, 1.0f, lane);
          if constexpr (kProbe) {
            probe_layer(c, near, b1, pl.h1, valid_rows, r0, col, 1.0f, lane, l1_unit, redone1,
                        missed1, worst1);
          }
          fix_edges(near, b1, h1s, pl.s1, r0, col, col, fix + 32 * warp, lane, l1_unit);
        }
      }
      // The twin's L2 sum: from 0 over h1's units in order (the padded
      // units add +0), W2's column from the transposed copy.
      auto l2_unit = [&](int row, int col) {
        float z = 0.0f;
        const bf16* hrow = h1s + row * pl.s1;
        const bf16* wcol = w2t + static_cast<int64_t>(col) * pl.k2;
        for (int k0 = 0; k0 < pl.k2; k0 += 8) {
          const uint4 hv = *reinterpret_cast<const uint4*>(hrow + k0);
          const uint4 wv = __ldg(reinterpret_cast<const uint4*>(wcol + k0));
          const uint32_t hw[4] = {hv.x, hv.y, hv.z, hv.w}, ww[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const float hk = j & 1 ? tc::hi_half(hw[j >> 1]) : tc::lo_half(hw[j >> 1]);
            const float wk = j & 1 ? tc::hi_half(ww[j >> 1]) : tc::lo_half(ww[j >> 1]);
            z = fmaf(hk, wk, z);
          }
        }
        return z;
      };

      // L2 = h1 W2 a 128-column pass at a time over the ring's slots, then
      // the bias and the ReLU into the pass's h2 rows, then the head's fold
      // of the pass's chunks.
      const int e = tid & (kTile - 1), o0 = tid / kTile;
      const bool two = o0 + 4 < kOut;
      float head0 = 0.0f, head1 = 0.0f;
      int t = 0;  // the tile's ring slot
      for (int pass = 0; pass < pl.n2p / kBfCols; ++pass) {
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
          for (int i = 0; i < 4; ++i) c[nt][i] = 0.0f;
        }
        for (int s = 0; s < slots_a_pass; ++s, ++t) {
          copy_wait_ring();
          bar_sync(kBarMlp, kMlp);  // slot t everyone's; h1 complete; slot t - 1 consumed
          if (t + kBfSlots - 1 < n_slots) {
            copy_slot(ring + ((t + kBfSlots - 1) % kBfSlots) * kBfRows * kColStride, w2,
                      t + kBfSlots - 1, slots_a_pass, pl, tid);
          }
          ow::copy_commit();
          const bf16* slot = ring + (t % kBfSlots) * kBfRows * kColStride;
          const int kk0 = kBfRows / 16 * s;
#pragma unroll
          for (int kk = 0; kk < kBfRows / 16; ++kk) {
            uint32_t a[4], b[4][4];
            tc::ldsm4(a, h1s + (r0 + tc::row_a(lane)) * pl.s1 + 16 * (kk0 + kk) + tc::col_a(lane));
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              tc::ldsm4t(b[j], slot + (16 * kk + tc::row_a(lane)) * kColStride + ch + 16 * j +
                                   tc::col_a(lane));
            }
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              tc::mma(c[2 * j], a, b[j][0], b[j][1]);
              tc::mma(c[2 * j + 1], a, b[j][2], b[j][3]);
            }
          }
        }
        const int col = kBfCols * pass + ch;
        const uint32_t near = relu_store(c, b2, pl.h2, h2s, kColStride, r0, col, ch, tie2, lane);
        if constexpr (kProbe) {
          probe_layer(c, near, b2, pl.h2, valid_rows, r0, col, tie2, lane, l2_unit, redone2,
                      missed2, worst2);
        }
        fix_edges(near, b2, h2s, kColStride, r0, col, ch, fix + 32 * warp, lane, l2_unit);
        bar_sync(kBarMlp, kMlp);  // the pass's h2 complete
        if (o0 < kOut) {
          const bf16* hrow = h2s + e * kColStride;
          for (int u = 0; u < kBfCols && kBfCols * pass + u < pl.n2; u += 32) {
            float h[32];
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const uint4 hv = *reinterpret_cast<const uint4*>(hrow + u + 8 * q);
              const uint32_t hw[4] = {hv.x, hv.y, hv.z, hv.w};
#pragma unroll
              for (int x = 0; x < 4; ++x) {
                h[8 * q + 2 * x] = tc::lo_half(hw[x]);
                h[8 * q + 2 * x + 1] = tc::hi_half(hw[x]);
              }
            }
            const int u0 = kBfCols * pass + u;
            head0 = head0 + chunk_fold(h, w3 + o0 * pl.n2p + u0);
            if (two) head1 = head1 + chunk_fold(h, w3 + (o0 + 4) * pl.n2p + u0);
          }
        }
      }
      // The head's outputs, once the env warps are done with this buffer.
      if (n >= 2) bar_sync(kBarFree + buf, kThreads);
      float* out = outs + buf * kOut * kTile;
      if (o0 < kOut) {
        out[o0 * kTile + e] = head0 + b3[o0];
        if (two) out[(o0 + 4) * kTile + e] = head1 + b3[o0 + 4];
      }
      bar_arrive(kBarReady + buf, kThreads);  // outs of tile n are ready
    }
    if constexpr (kProbe) {
      atomicAdd(probe + 0, redone1);
      atomicAdd(probe + 1, redone2);
      atomicAdd(probe + 2, missed1);
      atomicAdd(probe + 3, missed2);
      atomicMax(probe + 4, __float_as_uint(worst1));
      atomicMax(probe + 5, __float_as_uint(worst2));
    }
  } else {
    const int te = tid - kMlp;
    for (int n = 0; n < count; ++n) {
      const int buf = n & 1;
      const int64_t g = (blockIdx.x + static_cast<int64_t>(n) * gridDim.x) * kTile + te;
      bar_sync(kBarReady + buf, kThreads);
      if (g < batch) {
        float s[kD];
#pragma unroll
        for (int d = 0; d < kD; ++d) s[d] = s_in[d * batch + g];
        ow::env_step<Env, kMode>(s, outs + buf * kOut * kTile, kTile, te, g, batch, consts, seed,
                                 p, s_out, block);
      }
      if (n + 2 < count) bar_arrive(kBarFree + buf, kThreads);  // the MLP warps may refill
    }
  }
}

// Persistent CTAs, one an SM (or one a tile where there are fewer); with
// `ctas`, only the occupancy query.
template <class Env, int kMode, bool kProbe>
cudaError_t launch_mode(const float* s_in, int64_t batch, const Bf16Plan& pl, const Actor& w,
                        const float* consts, uint32_t seed, const float* params_host,
                        float* s_out, float* block, const void* scratch, unsigned* probe,
                        cudaStream_t st, int* ctas, long long* smem) {
  constexpr int kOut = (kMode == ow::kSac || kMode == ow::kSacDet) ? 2 * Env::kA : Env::kA;
  const int bytes = ow::bf16_smem(pl, kOut).bytes;
  int device = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return e;
  auto kernel = offpolicy_collect_wide_bf16_kernel<Env, kMode, kProbe>;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return e;
  if (ctas != nullptr) {
    *smem = bytes;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas, kernel, kThreads, bytes);
  }
  const int64_t tiles = (batch + kTile - 1) / kTile;
  const auto blocks = static_cast<unsigned int>(tiles < sms ? tiles : sms);
  kernel<<<blocks, kThreads, bytes, st>>>(s_in, batch, pl,
                                          static_cast<const unsigned char*>(scratch), w.b3, consts,
                                          seed, Env::params(params_host), s_out, block, probe);
  return cudaGetLastError();
}

}  // namespace

cudaError_t reinmav::offpolicy_wide::launch_bf16(int env_kind, int mode, const float* params_host,
                                                 const float* s_in, int64_t batch, int hidden1,
                                                 int hidden2, const Actor& w, const float* consts,
                                                 uint32_t seed, float* s_out, float* block,
                                                 const void* scratch, unsigned* probe,
                                                 cudaStream_t st, int* ctas, long long* smem) {
  const Bf16Plan pl = bf16_plan(hidden1, hidden2);
  return reinmav::with_env_kind(env_kind, [&](auto env) {
    using Env = decltype(env);
    if (probe != nullptr) {  // the probe: modes sac and td3
      if (mode == kSac) {
        return launch_mode<Env, kSac, true>(s_in, batch, pl, w, consts, seed, params_host,
                                            s_out, block, scratch, probe, st, ctas, smem);
      }
      if (mode == kTd3) {
        return launch_mode<Env, kTd3, true>(s_in, batch, pl, w, consts, seed, params_host,
                                            s_out, block, scratch, probe, st, ctas, smem);
      }
      return cudaErrorInvalidValue;
    }
    switch (mode) {
      case kSac:
        return launch_mode<Env, kSac, false>(s_in, batch, pl, w, consts, seed, params_host,
                                             s_out, block, scratch, nullptr, st, ctas, smem);
      case kSacDet:
        return launch_mode<Env, kSacDet, false>(s_in, batch, pl, w, consts, seed,
                                                params_host, s_out, block, scratch, nullptr, st,
                                                ctas, smem);
      case kTd3:
        return launch_mode<Env, kTd3, false>(s_in, batch, pl, w, consts, seed, params_host,
                                             s_out, block, scratch, nullptr, st, ctas, smem);
      case kTd3Det:
        return launch_mode<Env, kTd3Det, false>(s_in, batch, pl, w, consts, seed,
                                                params_host, s_out, block, scratch, nullptr, st,
                                                ctas, smem);
      default:
        return cudaErrorInvalidValue;
    }
  });
}

cudaError_t reinmav::offpolicy_wide::launch_bf16_pack(int d, int out, int hidden1, int hidden2,
                                                      const Actor& w, void* scratch,
                                                      cudaStream_t st) {
  const Bf16Plan pl = bf16_plan(hidden1, hidden2);
  int device = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return e;
  const int pack_tiles = (pl.k2 / 32) * (pl.n2p / 32);
  const int pack_blocks = pack_tiles < 4 * sms ? pack_tiles : 4 * sms;
  offpolicy_wide_pack_kernel<<<pack_blocks, 256, 0, st>>>(w, d, out, pl,
                                                          static_cast<unsigned char*>(scratch));
  return cudaGetLastError();
}
