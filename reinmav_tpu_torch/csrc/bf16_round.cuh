// The operand rounding of the kernels' bf16 instances (compute_dtype
// "bfloat16" in K2/K6, K3, K4 and K7): a value rounded to bf16 (round to
// nearest even, cvt.rn.bf16.f32) and kept as a float32.  A product of two
// such values has at most 16 significant bits, so it is exact in float32:
// an FMA chain over bf16-rounded operands rounds each sum once, as the
// plain twins' float32 additions of the same products do, and the float32
// bodies of the kernels serve the bf16 instances unchanged.  This is the
// TPU kernels' _mm (operands cast to bf16, preferred_element_type float32),
// and torch's x.to(torch.bfloat16).to(torch.float32)
// (reinmav_tpu_torch/rl/networks.py::bf16_round).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace reinmav {

// x rounded to bf16 when kBf16, else x unchanged.
template <bool kBf16>
__device__ __forceinline__ float bf16r(float x) {
  if constexpr (kBf16) {
    return __bfloat162float(__float2bfloat16_rn(x));
  } else {
    return x;
  }
}

template <bool kBf16>
__device__ __forceinline__ float4 bf16r(float4 v) {
  return make_float4(bf16r<kBf16>(v.x), bf16r<kBf16>(v.y), bf16r<kBf16>(v.z), bf16r<kBf16>(v.w));
}

}  // namespace reinmav
