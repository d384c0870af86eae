// The tensor-core fragments that the bf16 bodies of K2/K6 (ppo_rollout_body_
// bf16.cuh) and K7 (offpolicy_collect_bf16.cuh) share: mma.sync.aligned.
// m16n8k16.row.col.f32.bf16.bf16.f32, its operands read from shared memory
// with ldmatrix, bf16 packing, and the test for a float32 value that lies
// near the midpoint between its two bf16 neighbours.  (K3/K4's bf16 body,
// ppo_loss_body_bf16.cuh, keeps its own copies of these.)
//
// Fragment layout of an m16n8 float32 accumulator c[4] (lane = 4 g + q):
// c[0], c[1] are row g, columns 2q and 2q + 1; c[2], c[3] row g + 8.  An
// m16k16 A fragment a[4] holds, packed two bf16 a register, row g columns
// 2q, 2q + 1 (a[0]), row g + 8 (a[1]), row g columns 2q + 8, 2q + 9 (a[2]),
// row g + 8 (a[3]): the accumulators of two adjacent n8 tiles, packed, are
// the A fragment of the next product's k16 step.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace reinmav {
namespace tc {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ldmatrix of four 8 x 8 bf16 matrices, lane l giving the address of a row
// of matrix l / 8; .trans hands each thread the transpose's entry.
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

__device__ __forceinline__ void ldsm4t(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

// c += a b: a the m16k16 A fragment, (b0, b1) the k16n8 B fragment, c the
// m16n8 float32 accumulator.
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats rounded to bf16 (round to nearest even), lo in the low half.
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ void st_pair(bf16* p, uint32_t v) {
  *reinterpret_cast<uint32_t*>(p) = v;
}

// The low and the high bf16 of a packed pair, as float32 (exact).
__device__ __forceinline__ float lo_half(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float hi_half(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

__device__ __forceinline__ float to_float(bf16 v) { return __bfloat162float(v); }

// x rounded to bf16 and back (round to nearest even).
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// The row and column offsets a lane gives ldmatrix.x4 for an m16k16 A
// fragment from (m, k) rows, or two n8 B fragments from (k, n) rows with
// .trans: rows + lane % 16, columns + 8 (lane / 16).
__device__ __forceinline__ int row_a(int lane) { return lane & 15; }
__device__ __forceinline__ int col_a(int lane) { return (lane >> 4) << 3; }

// The row (of the 16) and the column (of the 8) of accumulator slot i (0-3)
// of an m16n8 tile for lane 4 g + q.
__device__ __forceinline__ int acc_row(int lane, int i) { return (lane >> 2) + 8 * (i >> 1); }
__device__ __forceinline__ int acc_col(int lane, int i) { return 2 * (lane & 3) + (i & 1); }

// The distance from v to the midpoint between its two bf16 neighbours,
// where another order of summation can round v the other way.
__device__ __forceinline__ float midpoint_distance(float v) {
  const float mid = __uint_as_float((__float_as_uint(v) & 0xffff0000u) | 0x8000u);
  return fabsf(v - mid);
}

// The warp's flagged accumulator slots handed out one a lane: the lanes'
// slot masks (`near`, up to 64 slots a lane) are numbered in lane order,
// and pass p gives item 32 p + l of that order to lane l, which runs
// fn(owner lane, slot) for it.  A lane thus recomputes another lane's
// output, and the warp takes ceil(items / 32) passes, not the most items
// one lane holds.  `list` is the warp's 32 words of shared memory.
// Returns the warp's items; the caller's later reads of what fn stored
// follow the last pass's __syncwarp.
template <class Fn>
__device__ __forceinline__ int for_each_flagged(uint64_t near, uint32_t* list, int lane, Fn&& fn) {
  const int mine = __popcll(near);
  int upto = mine;  // inclusive prefix over the lanes
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, upto, off);
    if (lane >= off) upto += v;
  }
  const int total = __shfl_sync(0xffffffffu, upto, 31);
  for (int base = 0; base < total; base += 32) {
    int idx = upto - mine;
    for (uint64_t m = near; m != 0; m &= m - 1, ++idx) {
      if (idx >= base && idx < base + 32) list[idx - base] = (lane << 8) | (__ffsll(m) - 1);
    }
    __syncwarp();
    if (base + lane < total) {
      const uint32_t item = list[lane];
      fn(static_cast<int>(item >> 8), static_cast<int>(item & 0xffu));
    }
    __syncwarp();
  }
  return total;
}

}  // namespace tc
}  // namespace reinmav
